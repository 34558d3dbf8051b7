"""Device tracing + compilation telemetry.

The reference's profiling story is a frame-timing ring + CSV capture
sessions (Renderer.cpp:6286-6391); the additions here are
`jax.profiler` traces (viewable in TensorBoard/Perfetto) and
jit-compilation cache statistics — recompiles are the analogue of
pipeline-rebuild hitches, so the engine surfaces them per frame.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Optional


@dataclass
class CompilationStats:
    """Executable-cache size of the engine's jitted frame function — a
    growing count between frames means a retrace happened (the analogue
    of a mid-run pipeline rebuild hitch)."""

    render_frame_variants: int


def compilation_stats() -> CompilationStats:
    variants = 0
    try:
        from trident.render.renderer import (
            render_frame, render_frame_bundled)

        # both frame entries: the bundled path is what the live renderer
        # dispatches; the pytree path serves benches/tools
        variants = (render_frame._cache_size()
                    + render_frame_bundled._cache_size())
    except Exception:
        pass
    return CompilationStats(render_frame_variants=int(variants))


class Profiler:
    """Start/stop device traces (the perf-capture-session analogue).

    trace_dir receives a TensorBoard-compatible trace; on backends without
    profiler support this degrades to a no-op with `active` False.
    """

    def __init__(self, trace_dir: str = "PerformanceCaptures/traces") -> None:
        self.trace_dir = trace_dir
        self.active = False

    def start(self) -> bool:
        if self.active:
            return True
        try:
            import jax

            os.makedirs(self.trace_dir, exist_ok=True)
            jax.profiler.start_trace(self.trace_dir)
            self.active = True
        except Exception:
            self.active = False
        return self.active

    def stop(self) -> Optional[str]:
        if not self.active:
            return None
        import jax

        jax.profiler.stop_trace()
        self.active = False
        return self.trace_dir


@contextlib.contextmanager
def profile_block(name: str):
    """Annotate a host-side block in the device trace (StepTraceAnnotation).
    The single `yield` sits OUTSIDE any except path: a yield in an except
    handler would make the generator yield twice when the USER'S block
    raises (contextlib throws into the first yield), replacing the real
    exception with RuntimeError(\"generator didn't stop after throw()\")."""
    try:
        import jax

        cm = jax.profiler.TraceAnnotation(name)
    except Exception:
        cm = contextlib.nullcontext()
    with cm:
        yield
