"""Frame-interpolation network: residual U-Net in plain JAX, NHWC.

Behavioral equivalent of the reference's PyTorch InterpolationUNet
(Scripts/train_frame_generator.py:139-217): enc 32→64→128 (stride-2 convs),
two residual bottleneck blocks, transpose-conv decoder with ADDITIVE skips,
sigmoid output. Differences by design: NHWC layout, BatchNorm with
optional cross-device axis sync, optional bfloat16 compute / f32 params.

Input: two frames concatenated on channels (B,H,W,6) in [0,1] →
output (B,H,W,3) the interpolated middle frame.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import jax
import jax.numpy as jnp

from trident.ai import nn

Array = jax.Array


def residual_block(p, stats, x: Array, train: bool, axis_name, dtype):
    """conv-BN-relu-conv-BN + identity, relu. Returns (y, new_stats)."""
    h = nn.conv(p["Conv_0"], x, dtype=dtype)
    h, s0 = nn.batch_norm(p["BatchNorm_0"], stats["BatchNorm_0"], h, train,
                          axis_name, dtype)
    h = nn.conv(p["Conv_1"], jax.nn.relu(h), dtype=dtype)
    h, s1 = nn.batch_norm(p["BatchNorm_1"], stats["BatchNorm_1"], h, train,
                          axis_name, dtype)
    return jax.nn.relu(h + x), {"BatchNorm_0": s0, "BatchNorm_1": s1}


def init_residual_block(rng: Array, c: int):
    k0, k1 = jax.random.split(rng)
    b0, s0 = nn.init_batch_norm(c)
    b1, s1 = nn.init_batch_norm(c)
    return ({"Conv_0": nn.init_conv(k0, 3, c, c, bias=False),
             "BatchNorm_0": b0,
             "Conv_1": nn.init_conv(k1, 3, c, c, bias=False),
             "BatchNorm_1": b1},
            {"BatchNorm_0": s0, "BatchNorm_1": s1})


# residual blocks in call order with their width multiplier
_BLOCK_WIDTHS = (1, 2, 4, 4, 4, 2, 1)


@dataclass(frozen=True)
class InterpolationUNet:
    input_channels: int = 6
    base_channels: int = 32
    dtype: Any = jnp.float32          # jnp.bfloat16 for mixed precision
    bn_axis_name: Optional[str] = None  # "dp" to sync batch stats over mesh

    def init(self, rng: Array, x: Array, train: bool = False):
        del train
        c = self.base_channels
        keys = jax.random.split(rng, 6 + len(_BLOCK_WIDTHS))
        params = {
            "Conv_0": nn.init_conv(keys[0], 3, x.shape[-1], c),
            "Conv_1": nn.init_conv(keys[1], 3, c, 2 * c),
            "Conv_2": nn.init_conv(keys[2], 3, 2 * c, 4 * c),
            "ConvTranspose_0": nn.init_conv(keys[3], 4, 4 * c, 2 * c),
            "ConvTranspose_1": nn.init_conv(keys[4], 4, 2 * c, c),
            "Conv_3": nn.init_conv(keys[5], 3, c, 3),
        }
        stats = {}
        for i, m in enumerate(_BLOCK_WIDTHS):
            name = f"ResidualBlock_{i}"
            params[name], stats[name] = init_residual_block(keys[6 + i],
                                                            m * c)
        return {"params": params, "batch_stats": stats}

    def apply(self, variables, x: Array, train: bool = False,
              mutable=None):
        """Forward pass. With `mutable=["batch_stats"]` (training) returns
        (out, {"batch_stats": updated running averages})."""
        p, stats = variables["params"], variables["batch_stats"]
        dt = self.dtype
        new_stats = {}

        def blk(i, h):
            name = f"ResidualBlock_{i}"
            h, new_stats[name] = residual_block(
                p[name], stats[name], h, train,
                self.bn_axis_name if train else None, dt)
            return h

        x = x.astype(dt)
        skip1 = blk(0, jax.nn.relu(nn.conv(p["Conv_0"], x, dtype=dt)))
        skip2 = blk(1, jax.nn.relu(nn.conv(p["Conv_1"], skip1, 2, dt)))
        h = blk(2, jax.nn.relu(nn.conv(p["Conv_2"], skip2, 2, dt)))
        h = blk(4, blk(3, h))
        h = jax.nn.relu(nn.conv_transpose(p["ConvTranspose_0"], h, 2, dt))
        h = blk(5, h) + skip2
        h = jax.nn.relu(nn.conv_transpose(p["ConvTranspose_1"], h, 2, dt))
        h = blk(6, h) + skip1
        out = jax.nn.sigmoid(
            nn.conv(p["Conv_3"], h, dtype=dt).astype(jnp.float32))
        if mutable:
            return out, {"batch_stats": new_stats}
        return out


def init_model(rng: Array, resolution=(256, 256), base_channels: int = 32,
               dtype=jnp.float32, bn_axis_name: Optional[str] = None):
    """Returns (model, variables) initialized at the given resolution."""
    model = InterpolationUNet(base_channels=base_channels, dtype=dtype,
                              bn_axis_name=bn_axis_name)
    dummy = jnp.zeros((1, resolution[0], resolution[1], 6), jnp.float32)
    return model, model.init(rng, dummy)
