"""Allocation / memory telemetry.

Reference: the global operator-new override counting per-frame heap
allocations (Core/Utilities.h:230-235, read each frame at
Renderer.cpp:739,829). The analogue here tracks two things per frame:
host-side Python allocations (tracemalloc) and device HBM usage
(PJRT memory stats when the backend exposes them).
"""

from __future__ import annotations

import tracemalloc
from dataclasses import dataclass
from typing import Optional


@dataclass
class FrameAllocStats:
    host_allocs: int = 0          # python allocations this frame
    host_bytes: int = 0           # net host bytes this frame
    device_bytes_in_use: int = 0  # HBM in use (0 if backend hides it)
    device_peak_bytes: int = 0


class AllocationTracker:
    """begin_frame/end_frame pair per frame; stats() reads the last frame.
    Host tracking costs ~5% — off by default, enable for debugging like the
    reference's debug-build counter."""

    def __init__(self, track_host: bool = False) -> None:
        self.track_host = track_host
        self._stats = FrameAllocStats()
        self._frame_start = (0, 0)
        self._started = False

    def begin_frame(self) -> None:
        if self.track_host:
            if not tracemalloc.is_tracing():
                tracemalloc.start()
            current, _peak = tracemalloc.get_traced_memory()
            counts = tracemalloc.get_tracemalloc_memory()
            self._frame_start = (current, counts)
        self._started = True

    def end_frame(self) -> None:
        if not self._started:
            return
        self._started = False
        if self.track_host and tracemalloc.is_tracing():
            current, _peak = tracemalloc.get_traced_memory()
            self._stats.host_bytes = current - self._frame_start[0]
            stats = tracemalloc.take_snapshot().statistics("filename")
            self._stats.host_allocs = sum(s.count for s in stats)
        self._stats.device_bytes_in_use, self._stats.device_peak_bytes = \
            device_memory_stats()

    def stats(self) -> FrameAllocStats:
        return self._stats


def device_memory_stats() -> tuple:
    """(bytes_in_use, peak_bytes) from the default device, 0s if opaque."""
    try:
        import jax

        stats = jax.local_devices()[0].memory_stats()
        if stats:
            return (int(stats.get("bytes_in_use", 0)),
                    int(stats.get("peak_bytes_in_use", 0)))
    except Exception:
        pass
    return 0, 0
