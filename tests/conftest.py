"""Test config. On a machine without a GPU the suite runs on the CPU with
a virtual 8-device mesh, so sharding tests exercise real shard_map
partitioning. Tests marked `gpu` need an NVIDIA GPU: the `gpu_device`
fixture decides at run time (never at import) and skips them elsewhere.
On the card they run with

    python -m pytest tests/ -m gpu -p no:cacheprovider

(chip_smoke.py does exactly that before its own phases)."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    # only affects the CPU backend; harmless on a GPU machine
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest

from trident.core.platform import compile_cache_dir

# Persistent compilation cache: the SPMD tests are compile-bound (the
# banded shard_map graphs take minutes EACH to build on a loaded machine).
compile_cache_dir()
import jax as _jax  # noqa: E402

_jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped where JAX finds none")


@pytest.fixture
def gpu_device():
    """The first GPU device, or skip the test."""
    import jax

    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (JAX found none)")
    return gpus[0]


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
