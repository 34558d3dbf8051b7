"""Per-frame input bundling: every host-varying value in TWO uploads.

Every host→device upload is a separate transfer, and the interactive
frame loop would otherwise ship ~20 small numpy arrays per frame (draw
transforms, shade rows, camera, lights, palette). Packing all of it into
ONE f32 blob + ONE i32 blob cuts that to two uploads; unpacking is free
slicing inside the jitted frame.

The geometry/plan/texture/skybox arrays are device-resident and cached by
version (renderer.py), so they never re-upload.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from trident.render.types import CameraParams, DrawParams, LightParams

# fixed-size header: camera(16+16+3) lights(4+3+4) light_cam(16+16+3)
# ai_blend(1) shadow_bias(1)
_CAM = 35
_LIGHTS = 11
_HDR = _CAM + _LIGHTS + _CAM + 2


class BundleShape(NamedTuple):
    """Static layout key (one jit specialization per shape bucket)."""

    d: int      # draw bucket
    p: int      # palette bucket
    lp: int     # point-light bucket (0/2/4/8)


def pack_frame(params: DrawParams, palette: np.ndarray, shade: np.ndarray,
               camera: CameraParams, lights: LightParams,
               light_camera: Optional[CameraParams], ai_blend: float,
               shadow_bias: float = 2e-3) -> Tuple[np.ndarray, np.ndarray,
                                                   BundleShape]:
    """Host-side: flatten every per-frame value → (f32 blob, i32 blob,
    shape). All inputs must be numpy-backed (build_draw_params /
    gather_lights / Camera.params produce numpy)."""
    d = shade.shape[0]
    p = palette.shape[0]
    lp = np.shape(lights.point_pos_range)[0]
    lc = light_camera if light_camera is not None else camera
    f32 = np.concatenate([
        np.ravel(params.xform_a), np.ravel(params.xform_b), np.ravel(shade),
        np.ravel(camera.view), np.ravel(camera.proj), np.ravel(camera.position),
        np.ravel(lights.ambient), np.ravel(lights.dir_direction),
        np.ravel(lights.dir_color),
        np.ravel(lc.view), np.ravel(lc.proj), np.ravel(lc.position),
        np.asarray([ai_blend, shadow_bias], np.float32),
        np.ravel(lights.point_pos_range),
        np.ravel(lights.point_color_intensity),
        np.ravel(palette),
    ]).astype(np.float32, copy=False)
    i32 = np.concatenate([
        np.ravel(params.texture_slot), np.ravel(params.bone_offset),
        np.ravel(params.bone_count),
        np.asarray([int(lights.dir_count), int(lights.point_count)]),
    ]).astype(np.int32, copy=False)
    return f32, i32, BundleShape(d, p, lp)


def unpack_frame(f32, i32, shape: BundleShape):
    """In-jit: blob slices → the frame-function pytrees. Returns
    (params, palette, shade, camera, lights, light_camera, ai_blend,
    shadow_bias). Fields the jitted pipeline never reads (model/tint/uv —
    they are folded into xform/shade at pack time) are zero placeholders
    that XLA dead-code-eliminates."""
    d, p, lp = shape
    o = 0

    def take(n, shp):
        nonlocal o
        v = f32[o:o + n].reshape(shp)
        o += n
        return v

    xform_a = take(d * 12, (d, 12))
    xform_b = take(d * 12, (d, 12))
    shade = take(d * 8, (d, 8))
    cam_view = take(16, (4, 4))
    cam_proj = take(16, (4, 4))
    cam_pos = take(3, (3,))
    ambient = take(4, (4,))
    dir_direction = take(3, (3,))
    dir_color = take(4, (4,))
    lc_view = take(16, (4, 4))
    lc_proj = take(16, (4, 4))
    lc_pos = take(3, (3,))
    ai_blend = f32[o]
    shadow_bias = f32[o + 1]
    o += 2
    point_pos_range = take(lp * 4, (lp, 4))
    point_color_intensity = take(lp * 4, (lp, 4))
    palette = take(p * 16, (p, 4, 4))
    # pack/unpack agree on ~16 field orderings by discipline alone; this
    # trace-time check turns any one-sided layout drift into a loud error
    # instead of silently mis-sliced lights/palette (shapes are static, so
    # it costs nothing at run time)
    expected = _HDR + d * 32 + lp * 8 + p * 16
    if o != expected or f32.shape[0] != expected:
        raise ValueError(
            f"frame bundle layout drift: consumed {o}, blob {f32.shape[0]}, "
            f"layout expects {expected} for shape {shape}")

    zero_d = jnp.zeros((d,), jnp.float32)
    params = DrawParams(
        model=jnp.zeros((d, 4, 4), jnp.float32),
        xform_a=xform_a, xform_b=xform_b,
        tint=jnp.zeros((d, 4), jnp.float32),
        uv_scale=jnp.zeros((d, 2), jnp.float32),
        uv_offset=jnp.zeros((d, 2), jnp.float32),
        tiling=zero_d,
        texture_slot=i32[0:d],
        material_index=jnp.zeros((d,), jnp.int32),
        bone_offset=i32[d:2 * d],
        bone_count=i32[2 * d:3 * d],
    )
    lights = LightParams(
        ambient=ambient, dir_direction=dir_direction, dir_color=dir_color,
        dir_count=i32[3 * d], point_pos_range=point_pos_range,
        point_color_intensity=point_color_intensity,
        point_count=i32[3 * d + 1])
    camera = CameraParams(view=cam_view, proj=cam_proj, position=cam_pos)
    light_cam = CameraParams(view=lc_view, proj=lc_proj, position=lc_pos)
    return (params, palette, shade, camera, lights, light_cam, ai_blend,
            shadow_bias)
