"""Utility surface: timing, logging, allocation telemetry, profiling."""

from trident.core.alloc import AllocationTracker, device_memory_stats
from trident.core.log import ConsoleLog, get_logger
from trident.core.timing import FrameTimingRing, FrameTimingStats, Time
from trident.utils.profiling import (
    Profiler,
    compilation_stats,
    profile_block,
)

__all__ = [
    "AllocationTracker", "device_memory_stats", "ConsoleLog", "get_logger",
    "FrameTimingRing", "FrameTimingStats", "Time",
    "Profiler", "compilation_stats", "profile_block",
]
