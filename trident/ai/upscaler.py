"""Neural 2× super-resolution: render at half resolution, reconstruct full.

The reference reserves its AI path for frame interpolation; this is the
companion the round-1 roadmap called "half-res shading + neural upsample
(DLSS-style reconstruction)": the renderer and the network share the
chip, so the half-res frame never leaves device memory and the net runs
inside the SAME jitted frame function.

The net is deliberately small (3 convs + depth-to-space, residual over a
bilinear upsample) — the point is a speed mode, not an offline enhancer. Train with
scripts/train_upscaler.py (procedurally generated scene pairs, no
dataset required); quality is reported as PSNR vs the bilinear baseline.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from trident.ai import nn

Array = jax.Array

# ---- V2 reconstruction path ------------------------------------------
# V1 pays two full-resolution RELAYOUTS per frame: the depth-to-space
# transpose and the warp's space-to-depth of the previous full-res frame.
# V2 removes both structurally:
#   * the net's OUTPUT BLOCKS (h, w, 12) — residual over a phase-shifted
#     bilinear base computed directly in block layout — ARE the next
#     frame's temporal history, so the warp gathers from (h, w, 12)
#     with no per-frame space-to-depth;
#   * the display frame comes from ONE depth-to-space whose interleave
#     a fixed one-hot 2×2 stride-2 conv_transpose performs — or a
#     zero-interleave pad+add — instead of the XLA transpose;
#   * conv arithmetic optionally runs in bf16 (UPSCALE_DTYPE) with f32
#     accumulation.
# V1 (apply_upscaler/warp_previous) is kept: training, checkpoints and
# the banded multi-chip path still use it, and the equivalence tests
# pin V2 to it. Toggle: the "upscale_v2" kernel knob (renderer jits key
# on kernel_knobs.trace_key()).
V2 = os.environ.get("TRIDENT_UPSCALE_V2", "1") == "1"
D2S_MODE = os.environ.get("TRIDENT_D2S", "convt")   # convt | pad | xla
UPSCALE_DTYPE = os.environ.get("TRIDENT_UPSCALE_DTYPE", "bf16")  # | f32


@dataclass(frozen=True)
class UpscalerNet:
    """(B, h, w, C) in [0,1] → (B, 2h, 2w, 3): bilinear base + learned
    residual detail via depth-to-space. Channel layouts (always rgb
    first; the bilinear base comes from those 3):

      3  rgb                      (spatial-only)
      4  rgb + depth              (G-buffer depth: silhouette edges are
                                   unambiguous where rgb alone aliases)
      16 rgb + temporal13         (warp_previous output)
      17 rgb + depth + temporal13
    """

    base_channels: int = 32
    dtype: Any = jnp.float32
    blocks: bool = False   # V2: return (b, h, w, 12) output blocks
                           # (residual over the block-layout bilinear
                           # base) instead of depth-to-spacing to full
                           # res — params are IDENTICAL either way

    def init(self, rng: Array, x: Array):
        c = self.base_channels
        k = jax.random.split(rng, 3)
        # zero-init the detail head: an untrained net IS the bilinear
        # baseline, and training learns pure residual detail from there
        return {"params": {
            "Conv_0": nn.init_conv(k[0], 3, x.shape[-1], c),
            "Conv_1": nn.init_conv(k[1], 3, c, c),
            "Conv_2": nn.init_conv(k[2], 3, c, c),
            "Conv_3": nn.init_conv(rng, 3, c, 12, zero=True)}}

    def apply(self, variables, x: Array) -> Array:
        p, dt = variables["params"], self.dtype
        h = jax.nn.relu(nn.conv(p["Conv_0"], x, dtype=dt))
        h = jax.nn.relu(nn.conv(p["Conv_1"], h, dtype=dt)) + h
        h = jax.nn.relu(nn.conv(p["Conv_2"], h, dtype=dt))
        h = nn.conv(p["Conv_3"], h, dtype=dt)
        if self.blocks:
            base12 = base_blocks(x[..., :3].astype(jnp.float32))
            return jnp.clip(base12 + h.astype(jnp.float32), 0.0, 1.0)
        b, hh, ww, _ = h.shape
        detail = h.reshape(b, hh, ww, 2, 2, 3).transpose(0, 1, 3, 2, 4, 5)
        detail = detail.reshape(b, hh * 2, ww * 2, 3).astype(jnp.float32)
        base = jax.image.resize(x[..., :3].astype(jnp.float32),
                                (b, hh * 2, ww * 2, 3), "bilinear")
        return jnp.clip(base + detail, 0.0, 1.0)


TEMPORAL_CHANNELS = 16   # 3 current + 12 warped-s2d + 1 validity (legacy id)
WARP_CHANNELS = 13       # warp_previous output width


def _axis_phases(v: Array, axis: int):
    """Quarter-pixel-shifted pair along `axis` (edge-clamped): the two 2×
    bilinear-upsample phases (i+0.5)/2-0.5 = i∓0.25 → 0.75·v[i]+0.25·v[i∓1].
    Weights 0.75/0.25 are exactly representable, matching
    jax.image.resize("bilinear") up to summation association."""
    n = v.shape[axis]
    lo = jnp.concatenate([jax.lax.slice_in_dim(v, 0, 1, axis=axis),
                          jax.lax.slice_in_dim(v, 0, n - 1, axis=axis)],
                         axis=axis)
    hi = jnp.concatenate([jax.lax.slice_in_dim(v, 1, n, axis=axis),
                          jax.lax.slice_in_dim(v, n - 1, n, axis=axis)],
                         axis=axis)
    return 0.75 * v + 0.25 * lo, 0.75 * v + 0.25 * hi


def base_blocks(rgb: Array) -> Array:
    """(…, h, w, 3) → (…, h, w, 12): the 2× bilinear base in BLOCK layout
    (channel (dy·2+dx)·3+c = output pixel (2y+dy, 2x+dx)) — four
    phase-shifted half-res lerps instead of a 4K resize + space-to-depth,
    so no output-resolution relayout ever materializes."""
    y0, y1 = _axis_phases(rgb, axis=rgb.ndim - 3)
    phases = []
    for vy in (y0, y1):
        x0, x1 = _axis_phases(vy, axis=rgb.ndim - 2)
        phases += [x0, x1]
    return jnp.concatenate(phases, axis=-1)


def _d2s_kernel() -> Array:
    k = np.zeros((2, 2, 12, 3), np.float32)
    for dy in range(2):
        for dx in range(2):
            for c in range(3):
                # conv_transpose applies the kernel spatially FLIPPED
                # (gradient semantics): channel phase (dy,dx) must land
                # at output offset (dy,dx), so it sits at kernel position
                # (1-dy, 1-dx)
                k[1 - dy, 1 - dx, (dy * 2 + dx) * 3 + c, c] = 1.0
    return jnp.asarray(k)


def depth_to_space(blocks: Array, mode: Optional[str] = None) -> Array:
    """(h, w, 12) [or batched] → (2h, 2w, 3). All three modes are
    BIT-EXACT relayouts (tested): `xla` is the reference
    reshape/transpose; `convt` does the interleave with a fixed one-hot 2×2
    stride-2 conv_transpose at HIGHEST precision (one exact 1.0·v term
    per output, f32 accumulate); `pad` builds four zero-interleaved
    phases with lax.pad interior padding and adds them (v+0+0+0)."""
    mode = mode or D2S_MODE
    squeeze = blocks.ndim == 3
    x = blocks[None] if squeeze else blocks
    b, h, w, _ = x.shape
    if mode == "xla":
        out = (x.reshape(b, h, w, 2, 2, 3).transpose(0, 1, 3, 2, 4, 5)
               .reshape(b, 2 * h, 2 * w, 3))
    elif mode == "convt":
        out = jax.lax.conv_transpose(
            x.astype(jnp.float32), _d2s_kernel(), strides=(2, 2),
            padding="VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=jax.lax.Precision.HIGHEST)
    elif mode == "pad":
        cfg = [(0, 0, 0), (0, 0, 1), (0, 0, 1), (0, 0, 0)]
        out = None
        for dy in range(2):
            for dx in range(2):
                ph = jax.lax.pad(x[..., (dy * 2 + dx) * 3:
                                   (dy * 2 + dx) * 3 + 3],
                                 jnp.float32(0), cfg)     # (b,2h-1,2w-1,3)
                ph = jnp.pad(ph, ((0, 0), (dy, 1 - dy), (dx, 1 - dx),
                                  (0, 0)))
                out = ph if out is None else out + ph
    else:
        raise ValueError(f"TRIDENT_D2S={mode!r}: expected convt|pad|xla")
    return out[0] if squeeze else out


def blocks_to_u8(blocks: Array) -> Array:
    """Quantize output blocks for the temporal history exactly like the
    display path quantizes (ops.deferred.pack_rgba8): V2's history feeds
    the SAME uint8 values V1 read back from the previous packed frame."""
    return jnp.round(blocks * 255.0).astype(jnp.uint8)


def init_upscaler(rng: Array, base_channels: int = 32, dtype=jnp.float32,
                  in_channels: int = 3):
    model = UpscalerNet(base_channels=base_channels, dtype=dtype)
    dummy = jnp.zeros((1, 32, 32, in_channels), jnp.float32)
    variables = model.init(rng, dummy)
    return model, variables


def upscaler_in_channels(params) -> int:
    """Input channel count from the first conv: 3/4/16/17 (see
    UpscalerNet's layout table)."""
    return int(params["Conv_0"]["kernel"].shape[-2])


def upscaler_wants_temporal(params) -> bool:
    return upscaler_in_channels(params) in (16, 17)


def upscaler_wants_depth(params) -> bool:
    return upscaler_in_channels(params) in (4, 17)


def _reproject_half(cur_depth: Array, cur_vp_inv: Array, prev_vp: Array,
                    full_width: int, full_height: int):
    """Half-res pixel centers → previous-frame FULL-res pixel coordinates
    (px, py) + previous clip w (shared by the V1 and V2 warps)."""
    h, w = cur_depth.shape
    hp = jax.lax.Precision.HIGHEST
    ys = (jnp.arange(h, dtype=jnp.float32) + 0.5) * (2.0 / h) - 1.0
    xs = (jnp.arange(w, dtype=jnp.float32) + 0.5) * (2.0 / w) - 1.0
    ndc_y, ndc_x = jnp.meshgrid(ys, xs, indexing="ij")
    ndc = jnp.stack([ndc_x, ndc_y, cur_depth, jnp.ones_like(ndc_x)], axis=-1)
    world = jnp.matmul(ndc, cur_vp_inv.T, precision=hp)
    prev_clip = jnp.matmul(world, prev_vp.T, precision=hp)
    pw = prev_clip[..., 3]
    safe_w = jnp.where(jnp.abs(pw) < 1e-8, 1e-8, pw)
    px = (prev_clip[..., 0] / safe_w + 1.0) * 0.5 * full_width
    py = (prev_clip[..., 1] / safe_w + 1.0) * 0.5 * full_height
    return px, py, pw


def warp_from_blocks(prev_blocks: Array, cur_depth: Array,
                     cur_vp_inv: Array, prev_vp: Array,
                     full_width: int, full_height: int) -> Array:
    """V2 warp: the previous frame's history is ALREADY the (h, w, 12)
    output-block layout (uint8 from blocks_to_u8, or f32), so the warp is
    the reprojection + ONE row gather per half-res pixel — no per-frame
    space-to-depth of the 4K frame (the V1 warp's dominant cost). Same
    block indexing and channel
    order as warp_previous's s2d, so outputs are bit-identical given
    equal history values (tested)."""
    hh, ww2 = prev_blocks.shape[0], prev_blocks.shape[1]
    px, py, pw = _reproject_half(cur_depth, cur_vp_inv, prev_vp,
                                 full_width, full_height)
    bx = jnp.round(px * 0.5 - 0.5).astype(jnp.int32)
    by = jnp.round(py * 0.5 - 0.5).astype(jnp.int32)
    in_bounds = ((bx >= 0) & (bx < ww2) & (by >= 0) & (by < hh)
                 & (pw > 1e-6) & (cur_depth < 1.0))

    blk = prev_blocks
    if blk.dtype == jnp.uint8:
        blk = blk.astype(jnp.float32) * (1.0 / 255.0)
    block = blk[jnp.clip(by, 0, hh - 1), jnp.clip(bx, 0, ww2 - 1)]
    valid = in_bounds[..., None].astype(jnp.float32)
    return jnp.concatenate([block * valid, valid], axis=-1)


def warp_previous(prev_rgb: Array, cur_depth: Array, cur_vp_inv: Array,
                  prev_vp: Array, full_width: int, full_height: int) -> Array:
    """Reproject the previous FULL-res frame into the current view at the
    half-res grid → (h, w, 13): the 2×2 full-res block under each
    reprojected point (space-to-depth, so full-res detail survives) + a
    validity channel (0 where the reprojection leaves the frame or the
    pixel is background).

    ONE 48-byte row gather per half-res pixel — packing the 2×2 block
    into the row makes the temporal input one gather instead of a
    bilinear 4-gather warp. prev_rgb (H, W, 3) f32 in [0,1]; cur_depth (h, w) from
    the half-res render; matrices are the full-frame view·proj (current
    inverted). Block alignment is ≤1 full-res pixel off — subpixel
    placement is the net's job (it predicts per-output-pixel residuals)."""
    px, py, pw = _reproject_half(cur_depth, cur_vp_inv, prev_vp,
                                 full_width, full_height)
    hh, ww2 = prev_rgb.shape[0] // 2, prev_rgb.shape[1] // 2
    s2d = prev_rgb[:hh * 2, :ww2 * 2].reshape(hh, 2, ww2, 2, 3) \
        .transpose(0, 2, 1, 3, 4).reshape(hh, ww2, 12)
    bx = jnp.round(px * 0.5 - 0.5).astype(jnp.int32)
    by = jnp.round(py * 0.5 - 0.5).astype(jnp.int32)
    in_bounds = ((bx >= 0) & (bx < ww2) & (by >= 0) & (by < hh)
                 & (pw > 1e-6) & (cur_depth < 1.0))
    block = s2d[jnp.clip(by, 0, hh - 1), jnp.clip(bx, 0, ww2 - 1)]
    valid = in_bounds[..., None].astype(jnp.float32)
    return jnp.concatenate([block * valid, valid], axis=-1)


def temporal_from_prev(params, prev, cur_depth: Array,
                       camera, out_width: int, out_height: int):
    """The render paths' shared history builder: `prev` is (previous
    full-res FrameOutput.color, previous view·proj) or None. Returns the
    warp_previous channels for a temporal net, or None when there is no
    history or the net is spatial-only. uint8 history is normalized; the
    current view·proj is rebuilt at HIGHEST precision (the matmul
    precision rule — geometry through bf16 grows artifacts)."""
    if prev is None or not upscaler_wants_temporal(params):
        return None
    prev_color, prev_vp = prev
    hp = jax.lax.Precision.HIGHEST
    vp = jnp.matmul(camera.proj, camera.view, precision=hp)
    if prev_color.shape[-1] == 12:
        # V2 block-layout history (FrameOutput.history): no space-to-depth
        return warp_from_blocks(prev_color, cur_depth, jnp.linalg.inv(vp),
                                prev_vp, out_width, out_height)
    prev_rgb = prev_color[..., :3]
    if prev_rgb.dtype == jnp.uint8:
        prev_rgb = prev_rgb.astype(jnp.float32) * (1.0 / 255.0)
    return warp_previous(prev_rgb, cur_depth, jnp.linalg.inv(vp), prev_vp,
                         out_width, out_height)


def apply_upscaler(params, image: Array, temporal: Array = None,
                   depth: Array = None) -> Array:
    """(H, W, 3) [0,1] → (2H, 2W, 3). Pure — safe inside the frame jit.
    Channel widths are inferred from the params, so no static config has
    to ride along. `temporal`: the (H, W, 13) warp_previous output;
    `depth`: the (H, W) half-res G-buffer depth ([0,1], 1 = background).
    Inputs a checkpoint doesn't want are ignored; wanted-but-missing
    inputs degrade to zeros (temporal: valid=0 teaches 'fall back to
    spatial'; depth: background)."""
    bc = params["Conv_0"]["kernel"].shape[-1]
    model = UpscalerNet(base_channels=bc)
    x = _assemble_inputs(params, image, temporal, depth)
    return model.apply({"params": params}, x[None])[0]


def _assemble_inputs(params, image: Array, temporal, depth) -> Array:
    parts = [image]
    if upscaler_wants_depth(params):
        if depth is None:
            depth = jnp.ones(image.shape[:2], jnp.float32)
        parts.append(depth[..., None].astype(jnp.float32))
    if upscaler_wants_temporal(params):
        if temporal is None:
            temporal = jnp.zeros(
                (*image.shape[:2], WARP_CHANNELS), jnp.float32)
        parts.append(temporal)
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=-1)


def apply_upscaler_v2(params, image: Array, temporal: Array = None,
                      depth: Array = None) -> Tuple[Array, Array]:
    """V2 reconstruction: → (rgb (2H, 2W, 3) f32, blocks (H, W, 12) f32).
    Same params/semantics as apply_upscaler, restructured so that the
    net returns output BLOCKS (residual over the block-layout bilinear
    base — no 4K resize, no transpose), the display frame is ONE
    depth_to_space, and `blocks` (via blocks_to_u8) is the next frame's
    warp history. Convs compute in UPSCALE_DTYPE (bf16 default, f32
    accumulation); set "f32" for bit-level V1 comparisons."""
    bc = params["Conv_0"]["kernel"].shape[-1]
    dt = jnp.bfloat16 if UPSCALE_DTYPE == "bf16" else jnp.float32
    model = UpscalerNet(base_channels=bc, dtype=dt, blocks=True)
    x = _assemble_inputs(params, image, temporal, depth)
    blocks = model.apply({"params": params}, x[None])[0]
    return depth_to_space(blocks), blocks


def save_upscaler(params, directory: str) -> str:
    os.makedirs(directory, exist_ok=True)
    path = nn.save_npz(os.path.abspath(os.path.join(directory,
                                                    "params.npz")),
                       {"params": jax.device_get(params)})
    with open(os.path.join(directory, "meta.json"), "w") as f:
        # both meta fields are INFERRED from params (exactly how
        # apply_upscaler infers them at run time) — a caller-supplied
        # width that disagreed with the actual weights would write a
        # checkpoint load_upscaler can never restore
        json.dump({"base_channels": int(params["Conv_0"]["kernel"].shape[-1]),
                   "scale": 2,
                   "in_channels": upscaler_in_channels(params)}, f)
    return path


def load_upscaler(directory: str):
    """Returns (params, base_channels) or raises."""
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    params = nn.load_npz(os.path.join(directory, "params.npz"))["params"]
    bc = int(meta.get("base_channels", 32))
    if upscaler_in_channels(params) != int(meta.get("in_channels", 3)):
        raise ValueError(f"{directory}: params do not match meta.json")
    return params, bc


def psnr(a: Array, b: Array) -> Array:
    mse = jnp.mean(jnp.square(a - b))
    return -10.0 * jnp.log10(jnp.maximum(mse, 1e-10))
