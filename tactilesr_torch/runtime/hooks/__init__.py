from .builtin import CheckpointHook, EvalHook, LoggerHook, LRUpdateHook
from .hookbase import HookBase
from .profiler import ProfilerHook

__all__ = ["HookBase", "LRUpdateHook", "CheckpointHook", "EvalHook", "LoggerHook", "ProfilerHook"]
