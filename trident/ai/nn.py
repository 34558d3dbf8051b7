"""Plain-JAX layers, parameter pytrees and checkpoints for the two nets.

The nets keep the parameter layout they were trained with: nested dicts
keyed by layer name in call order ("Conv_0", "ResidualBlock_1",
"BatchNorm_0", ...), with HWIO kernels, so existing weights load as they
are. Checkpoints are one `.npz` per pytree, keys joined by "/".
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp
import optax

Array = jax.Array
_DN = ("NHWC", "HWIO", "NHWC")
BN_MOMENTUM = 0.99
BN_EPS = 1e-5


def conv(p: Dict[str, Array], x: Array, stride: int = 1,
         dtype=jnp.float32) -> Array:
    """3×3 (or any odd k×k) convolution, 'same' padding, optional bias;
    operands computed in `dtype`."""
    k = p["kernel"]
    pad = k.shape[0] // 2
    y = jax.lax.conv_general_dilated(
        x.astype(dtype), k.astype(dtype), (stride, stride),
        [(pad, pad), (pad, pad)], dimension_numbers=_DN)
    if "bias" in p:
        y = y + p["bias"].astype(dtype)
    return y


def conv_transpose(p: Dict[str, Array], x: Array, stride: int = 2,
                   dtype=jnp.float32) -> Array:
    """Strided transposed convolution with 'SAME' padding and bias."""
    y = jax.lax.conv_transpose(
        x.astype(dtype), p["kernel"].astype(dtype), (stride, stride), "SAME",
        dimension_numbers=_DN)
    return y + p["bias"].astype(dtype)


def batch_norm(p: Dict[str, Array], stats: Dict[str, Array], x: Array,
               train: bool, axis_name: Optional[str] = None,
               dtype=jnp.float32):
    """BatchNorm over N, H, W. Returns (y, new_stats): in training the
    batch statistics normalize (averaged over `axis_name` when set) and
    the running averages update; otherwise the running averages apply."""
    xf = x.astype(jnp.float32)
    if train:
        mean = jnp.mean(xf, axis=(0, 1, 2))
        mean2 = jnp.mean(jnp.square(xf), axis=(0, 1, 2))
        if axis_name is not None:
            mean, mean2 = jax.lax.pmean((mean, mean2), axis_name)
        var = jnp.maximum(mean2 - jnp.square(mean), 0.0)
        stats = {"mean": BN_MOMENTUM * stats["mean"]
                 + (1.0 - BN_MOMENTUM) * mean,
                 "var": BN_MOMENTUM * stats["var"]
                 + (1.0 - BN_MOMENTUM) * var}
    else:
        mean, var = stats["mean"], stats["var"]
    y = (xf - mean) * (jax.lax.rsqrt(var + BN_EPS) * p["scale"]) + p["bias"]
    return y.astype(dtype), stats


def init_conv(rng: Array, k: int, cin: int, cout: int, bias: bool = True,
              zero: bool = False) -> Dict[str, Array]:
    shape = (k, k, cin, cout)
    kernel = (jnp.zeros(shape, jnp.float32) if zero else
              jax.nn.initializers.lecun_normal()(rng, shape, jnp.float32))
    p = {"kernel": kernel}
    if bias:
        p["bias"] = jnp.zeros((cout,), jnp.float32)
    return p


def init_batch_norm(c: int):
    """(params, stats) of a fresh BatchNorm."""
    return ({"scale": jnp.ones((c,), jnp.float32),
             "bias": jnp.zeros((c,), jnp.float32)},
            {"mean": jnp.zeros((c,), jnp.float32),
             "var": jnp.ones((c,), jnp.float32)})


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for name, v in tree.items():
        key = f"{prefix}{name}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(v)
    return tree


def save_npz(path: str, tree: Dict[str, Any]) -> str:
    with open(path, "wb") as f:
        np.savez(f, **flatten(tree))
    return path


def load_npz(path: str) -> Dict[str, Any]:
    with np.load(path) as z:
        return unflatten({k: z[k] for k in z.files})


@dataclasses.dataclass(frozen=True)
class TrainState:
    """Optimizer state for one model: the pytree leaves are step, params,
    batch_stats and opt_state; apply_fn and tx are static."""

    step: Array
    params: Any
    batch_stats: Any
    opt_state: Any
    apply_fn: Callable
    tx: optax.GradientTransformation

    @classmethod
    def create(cls, *, apply_fn, params, tx, batch_stats=None):
        return cls(step=jnp.asarray(0, jnp.int32), params=params,
                   batch_stats=batch_stats, opt_state=tx.init(params),
                   apply_fn=apply_fn, tx=tx)

    def apply_gradients(self, *, grads) -> "TrainState":
        updates, opt_state = self.tx.update(grads, self.opt_state,
                                            self.params)
        return dataclasses.replace(
            self, step=self.step + 1,
            params=optax.apply_updates(self.params, updates),
            opt_state=opt_state)

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


jax.tree_util.register_dataclass(
    TrainState, data_fields=["step", "params", "batch_stats", "opt_state"],
    meta_fields=["apply_fn", "tx"])
