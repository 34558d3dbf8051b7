"""Device-mesh helpers for SPMD training/rendering.

The reference is single-GPU (SURVEY.md §2: no DP/TP/PP exist); scaling here
uses a (dp, tp) mesh where the interpolation net trains
data-parallel over batch with tensor-parallel conv channels, and the
renderer can shard framebuffer tiles over dp. XLA inserts the collectives
(psum for grads / batch-norm stats, all-gathers at layout boundaries) —
there is no hand-written NCCL analogue.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (dp, tp) mesh. tp defaults to 2 when n is even, else 1."""
    devices = list(devices if devices is not None else jax.devices())
    n = n_devices or len(devices)
    devices = devices[:n]
    if tp is None:
        tp = 2 if n % 2 == 0 and n >= 2 else 1
    dp = n // tp
    assert dp * tp == n, f"n_devices={n} not divisible by tp={tp}"
    arr = np.asarray(devices).reshape(dp, tp)
    return Mesh(arr, axis_names=("dp", "tp"))


def param_sharding(mesh: Mesh, params, min_size: int = 2):
    """Sharding pytree for model params: shard the LAST axis over 'tp' when
    divisible (conv output channels / dense features); replicate the rest."""
    tp = mesh.shape["tp"]

    def rule(leaf):
        if (hasattr(leaf, "ndim") and leaf.ndim >= 1
                and leaf.shape[-1] % tp == 0 and leaf.shape[-1] >= max(tp, min_size)):
            spec = [None] * (leaf.ndim - 1) + ["tp"]
            return NamedSharding(mesh, P(*spec))
        return NamedSharding(mesh, P())

    return jax.tree.map(rule, params)


def batch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard axis 0 (batch) over 'dp'."""
    return NamedSharding(mesh, P("dp", *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
