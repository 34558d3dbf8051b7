"""Deferred resolve: winner-triangle GBuffer → shaded RGBA8 frame.

The reference shades every fragment inside the raster pass; here each pixel
is shaded exactly once AFTER visibility, in one fused XLA pass that fetches
TWO packed plane-table rows per pixel (ops/planes.py) plus texels:

  * normals / UVs interpolate as rational screen functions from the planes
  * world position is reconstructed from the depth buffer via the inverse
    view-projection (no per-vertex gather at all)
  * per-draw material state rides in the plane tables as constants
  * the mip level comes from the analytic UV screen derivatives
  * texture sampling quality is a static knob: nearest (1 gather),
    bilinear (4), trilinear (8)

Then Cook-Torrance PBR (exact reference math), skybox background, Reinhard
tonemap + gamma, optional AI blend.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from trident.ops import shading
from trident.ops.planes import AttributePlanes
from trident.render.types import (
    AiBlend,
    CameraParams,
    GBuffer,
    LightParams,
    SkyboxCube,
    TextureArrays,
)

Array = jax.Array


def _background(camera: CameraParams, skybox: Optional[SkyboxCube],
                width: int, height: int, clear_color,
                y_offset=0.0, full_height: Optional[int] = None) -> Array:
    """Skybox (sampled by world-space view ray) or clear color. For a
    multi-chip band, `y_offset`/`full_height` place these rows inside the
    full frame so the ray math is bit-identical to the single-chip render
    (the camera is always the FULL-frame camera)."""
    clear = jnp.broadcast_to(
        jnp.asarray(clear_color[:3], jnp.float32), (height, width, 3))
    if skybox is None:
        return clear
    fh = height if full_height is None else full_height
    ys = (jnp.arange(height, dtype=jnp.float32)
          + jnp.asarray(y_offset, jnp.float32) + 0.5) / fh * 2.0 - 1.0
    xs = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width * 2.0 - 1.0
    ny, nx = jnp.meshgrid(ys, xs, indexing="ij")
    # invert the projective xy map at z_view = -1
    x_v = (nx + camera.proj[0, 2]) / camera.proj[0, 0]
    y_v = (ny + camera.proj[1, 2]) / camera.proj[1, 1]
    dir_view = jnp.stack([x_v, y_v, -jnp.ones_like(x_v)], axis=-1)
    dir_world = jnp.matmul(dir_view, camera.view[:3, :3],
                           precision=jax.lax.Precision.HIGHEST)
    sky = shading.sample_skybox(skybox.faces, dir_world)
    return jnp.where(skybox.valid, sky, clear)


def deferred_shade(gbuffer: GBuffer, planes: AttributePlanes,
                   textures: TextureArrays, camera: CameraParams,
                   lights: LightParams, width: int, height: int,
                   clear_color=(0.05, 0.05, 0.08, 1.0),
                   skybox: Optional[SkyboxCube] = None,
                   ai: Optional[AiBlend] = None,
                   sampling: str = "bilinear",
                   shadow=None, shadow_pcf: bool = False,
                   tonemap: bool = True, y_offset=0,
                   full_height: Optional[int] = None,
                   shader_fn=None) -> Array:
    """Shade the frame → (H,W,4) f32. tonemap=True gives display-space
    [0,1] with the AI blend applied; tonemap=False gives linear HDR (for a
    bloom pass; the caller tonemaps and AI-blends). `y_offset` (int or
    traced i32) + `full_height`: this frame is the band of a full_height
    frame starting at that global row (multi-chip path) — planes, world
    reconstruction and skybox rays all evaluate at global coordinates with
    the FULL-frame camera, bit-identically to single-chip."""
    tri = gbuffer.tri_id                                  # (H,W)
    covered = tri >= 0
    tri_safe = jnp.maximum(tri, 0)

    # gather f16 rows (32 B), compute in f32; .astype is a no-op for f32
    # tables
    a = planes.table_a[tri_safe].astype(jnp.float32)      # (H,W,16)
    b = planes.table_b[tri_safe].astype(jnp.float32)      # (H,W,16)

    ys = (jnp.arange(height, dtype=jnp.float32)
          + jnp.asarray(y_offset, jnp.float32) + 0.5)
    xs = jnp.arange(width, dtype=jnp.float32) + 0.5
    py, px = jnp.meshgrid(ys, xs, indexing="ij")
    # per-triangle anchored pixel coords (anchors are 0 for f32 tables)
    px_l = px - b[..., 11]
    py_l = py - b[..., 12]

    def dot_plane(g):                                     # (H,W,3) → (H,W)
        return g[..., 0] * px_l + g[..., 1] * py_l + g[..., 2]

    denom = dot_plane(a[..., 0:3])
    inv = 1.0 / jnp.where(jnp.abs(denom) < 1e-20, 1e-20, denom)

    normal = jnp.stack([dot_plane(a[..., 3:6]), dot_plane(a[..., 6:9]),
                        dot_plane(a[..., 9:12])], axis=-1) * inv[..., None]
    normal = shading._normalize(normal)
    u_num = dot_plane(a[..., 12:15])
    v_num = dot_plane(b[..., 0:3])
    uv = jnp.stack([u_num, v_num], axis=-1) * inv[..., None]

    color_factor = b[..., 3:7]
    metallic = b[..., 7:8]
    roughness = b[..., 8:9]
    ambient_strength = b[..., 9:10]
    slot = b[..., 10].astype(jnp.int32)

    if planes.table_c is not None:
        c = planes.table_c[tri_safe].astype(jnp.float32)
        vcolor = jnp.stack([dot_plane(c[..., 0:3]), dot_plane(c[..., 3:6]),
                            dot_plane(c[..., 6:9])], axis=-1) * inv[..., None]
    else:
        vcolor = None

    # analytic UV derivatives for the mip level: d(u)/dx = (gU_x − u·g1_x)·inv
    g1x, g1y = a[..., 0], a[..., 1]
    du_dx = (a[..., 12] - uv[..., 0] * g1x) * inv
    du_dy = (a[..., 13] - uv[..., 0] * g1y) * inv
    dv_dx = (b[..., 0] - uv[..., 1] * g1x) * inv
    dv_dy = (b[..., 1] - uv[..., 1] * g1y) * inv
    size_row = textures.sizes[slot]                       # ONE (…,4) gather
    tex_size = size_row[..., :2].astype(jnp.float32)
    rho = jnp.maximum(
        jnp.square(du_dx * tex_size[..., 0]) + jnp.square(dv_dx * tex_size[..., 1]),
        jnp.square(du_dy * tex_size[..., 0]) + jnp.square(dv_dy * tex_size[..., 1]),
    )
    mip = 0.5 * jnp.log2(jnp.maximum(rho, 1e-12))
    if vcolor is not None:
        color_factor = jnp.concatenate(
            [color_factor[..., :3] * vcolor, color_factor[..., 3:4]], axis=-1)

    # the mip math already gathered the sizes row — reuse it so the
    # sampler's level geometry is gather-free
    size_hint = (size_row[..., 0], size_row[..., 1],
                 size_row[..., 2], size_row[..., 3])
    return _shade_common(
        gbuffer, covered, normal, uv, mip, color_factor, metallic, roughness,
        ambient_strength, slot, textures, camera, lights, width, height,
        clear_color, skybox, ai, sampling, shadow, shadow_pcf, tonemap,
        size_hint=size_hint, y_offset=y_offset, full_height=full_height,
        shader_fn=shader_fn)


def _shade_common(gbuffer, covered, normal, uv, mip, color_factor, metallic,
                  roughness, ambient_strength, slot, textures, camera,
                  lights, width, height, clear_color, skybox, ai, sampling,
                  shadow, shadow_pcf, tonemap, size_hint=None,
                  y_offset=0, full_height=None,
                  shader_fn=None) -> Array:
    """Texture sample + PBR + background/tonemap/AI. `slot` is unused (may
    be None) when size_hint carries the per-pixel texture geometry.
    `shader_fn` replaces the built-in Cook-Torrance lighting with a user
    shading function (render/shader_hook.py contract) — the
    hot-reloadable-GLSL analogue."""
    sampled = shading.sample_texture(textures, slot, uv, mip,
                                     mode=sampling, size_hint=size_hint)

    albedo = sampled[..., :3] * color_factor[..., :3]
    alpha = color_factor[..., 3:4] * sampled[..., 3:4]

    # world position from depth: world_h = (P·V)⁻¹ · (ndc, 1); for a band,
    # global rows over the full height keep this bit-identical single-chip
    fh = height if full_height is None else full_height
    ys = (jnp.arange(height, dtype=jnp.float32)
          + jnp.asarray(y_offset, jnp.float32) + 0.5)
    xs = jnp.arange(width, dtype=jnp.float32) + 0.5
    py, px = jnp.meshgrid(ys, xs, indexing="ij")
    hp = jax.lax.Precision.HIGHEST
    vp_inv = jnp.linalg.inv(jnp.matmul(camera.proj, camera.view,
                                       precision=hp))
    ndc_x = px * (2.0 / width) - 1.0
    ndc_y = py * (2.0 / fh) - 1.0
    ndc = jnp.stack([ndc_x, ndc_y, gbuffer.depth, jnp.ones_like(ndc_x)], axis=-1)
    world_h = jnp.matmul(ndc, vp_inv.T, precision=hp)
    world = world_h[..., :3] / jnp.where(
        jnp.abs(world_h[..., 3:4]) < 1e-20, 1e-20, world_h[..., 3:4])

    dir_shadow = None
    if shadow is not None:
        from trident.ops.shadow import shadow_factor

        dir_shadow = shadow_factor(shadow, world, pcf=shadow_pcf)
    shade = shading.shade_pbr if shader_fn is None else shader_fn
    lit = shade(world, normal, albedo, metallic, roughness,
                ambient_strength, camera.position, lights,
                dir_shadow=dir_shadow)
    background = _background(camera, skybox, width, height, clear_color,
                             y_offset=y_offset, full_height=full_height)
    a_out = jnp.where(covered[..., None], alpha, clear_color[3])

    if not tonemap:
        # linear HDR out; background treated as linear
        rgb = jnp.where(covered[..., None], lit, background)
        return jnp.concatenate([rgb, a_out], axis=-1)

    shaded = shading.tonemap_reinhard_gamma(lit)
    rgb = jnp.where(covered[..., None], shaded, background)
    out = jnp.concatenate([rgb, a_out], axis=-1)
    out = apply_ai_blend(out, ai)
    return jnp.clip(out, 0.0, 1.0)


def apply_ai_blend(out: Array, ai: Optional[AiBlend]) -> Array:
    """Final display-space mix with the interpolated AI frame
    (Default.frag:182-191 semantics)."""
    if ai is None:
        return out
    blend = jnp.clip(ai.blend, 0.0, 1.0)
    ai_rgba = jnp.concatenate(
        [ai.image, jnp.ones((*ai.image.shape[:2], 1), jnp.float32)], axis=-1)
    return out * (1.0 - blend) + ai_rgba * blend


def pack_rgba8(frame: Array) -> Array:
    return jnp.round(frame * 255.0).astype(jnp.uint8)
