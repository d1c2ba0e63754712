"""Runtime: the trainer, its hooks, optimizer, schedules, checkpoint bundles
and device selection."""
from .hooks import CheckpointHook, EvalHook, HookBase, LoggerHook, LRUpdateHook, ProfilerHook

__all__ = ["HookBase", "LRUpdateHook", "CheckpointHook", "EvalHook", "LoggerHook", "ProfilerHook"]
