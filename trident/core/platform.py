"""Which device the program computes on, and what that selects.

The renderer supports two JAX platforms: an NVIDIA GPU, where the
production kernels run compiled, and the CPU, where the tests run and the
O(T·pixels) oracle is the default raster (a test may still ask for the
GPU kernel, which then runs in the Pallas interpreter). Any other
platform is an error, never a silent fallback.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

SUPPORTED = ("gpu", "cpu")


def platform() -> str:
    """'gpu' or 'cpu' — the default JAX backend — or raise."""
    p = jax.default_backend()
    if p not in SUPPORTED:
        raise RuntimeError(
            f"unsupported JAX platform {p!r}: this renderer runs on an "
            f"NVIDIA GPU, or on the CPU for tests ({SUPPORTED})")
    return p


def raster_mode(use_pallas: Optional[bool] = None) -> str:
    """The visibility path: "pallas" (the tile-binned Triton kernel) on
    the GPU, "ref" (the oracle) on the CPU unless `use_pallas` asks for
    the kernel explicitly."""
    p = platform()
    if use_pallas is None:
        use_pallas = p == "gpu"
    return "pallas" if use_pallas else "ref"


def raster_interpret() -> bool:
    """Pallas kernels run in the interpreter exactly when on the CPU."""
    return platform() == "cpu"


def compile_cache_dir() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory: `JAX_COMPILATION_CACHE_DIR` when set (JAX reads it itself,
    and nothing else is configured), else `.jax_cache/` at the root of
    this checkout."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
