from .builtin import CheckpointHook, EvalHook, LoggerHook, LRUpdateHook
from .hookbase import HookBase

__all__ = ["HookBase", "LRUpdateHook", "CheckpointHook", "EvalHook", "LoggerHook"]
