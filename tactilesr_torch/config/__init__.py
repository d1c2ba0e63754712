from .default import common_config, root_path, tactileSeqs_config, tactileSR_config, tPSFNet_config
from .parser import ConfigArgumentParser, add_config_args, apply_overrides

__all__ = [
    "ConfigArgumentParser",
    "add_config_args",
    "apply_overrides",
    "common_config",
    "root_path",
    "tPSFNet_config",
    "tactileSR_config",
    "tactileSeqs_config",
]
