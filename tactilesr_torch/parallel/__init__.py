from .dist import check_single_device, get_rank, get_world_size, is_main_process

__all__ = ["get_rank", "get_world_size", "is_main_process", "check_single_device"]
