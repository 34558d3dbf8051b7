"""Directional-light shadow mapping: the two-pass render graph.

Pass 1 renders a light-POV depth map by reusing the exact same vertex →
setup → visibility pipeline (depth only). Pass 2 (in deferred shading)
projects the reconstructed world position into light clip space and
compares against ONE gathered shadow texel (four with PCF).

The reference reserves LightComponent::m_ShadowCaster but never implements
shadows (SURVEY §2); this completes the feature (BASELINE config 3's
"shadow-map pass").
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from trident.mathx.transforms import look_at, ortho_rh_zo
from trident.ops.vertex import triangle_setup, vertex_stage
from trident.render.types import CameraParams, DrawParams, DrawPlan, GeometryBuffers, ShadowParams

Array = jax.Array


def light_camera(direction: np.ndarray, center: np.ndarray, radius: float) -> CameraParams:
    """Orthographic light camera covering a bounding sphere (host-side)."""
    d = np.asarray(direction, np.float32)
    d = d / max(np.linalg.norm(d), 1e-8)
    center = np.asarray(center, np.float32)
    radius = max(float(radius), 1e-3)
    eye = center - d * radius * 2.0
    up = np.array([0.0, 1.0, 0.0], np.float32)
    if abs(float(d @ up)) > 0.95:
        up = np.array([1.0, 0.0, 0.0], np.float32)
    view = np.asarray(look_at(eye, center, up), np.float32)
    proj = np.asarray(ortho_rh_zo(-radius, radius, -radius, radius,
                                  0.01, radius * 4.0), np.float32)
    return CameraParams(view=view, proj=proj,
                        position=np.asarray(eye, np.float32))


def scene_bounds(records, packed) -> Tuple[np.ndarray, float]:
    """(center, radius) of the drawn scene — world-space union of the
    transformed per-mesh bboxes (host-side, cheap)."""
    lo = np.full(3, np.inf, np.float32)
    hi = np.full(3, -np.inf, np.float32)
    for rec in records:
        info = packed.draw_infos[rec.mesh_index]
        first = info.base_vertex
        idx = packed.indices[info.first_index:info.first_index + info.index_count]
        count = int(idx.max()) + 1 if info.index_count else 0
        if count == 0:
            continue
        verts = packed.positions[first:first + count]
        mlo, mhi = verts.min(axis=0), verts.max(axis=0)
        corners = np.array([[x, y, z, 1.0]
                            for x in (mlo[0], mhi[0])
                            for y in (mlo[1], mhi[1])
                            for z in (mlo[2], mhi[2])], np.float32)
        world = corners @ rec.model.T
        lo = np.minimum(lo, world[:, :3].min(axis=0))
        hi = np.maximum(hi, world[:, :3].max(axis=0))
    if not np.isfinite(lo).all():
        return np.zeros(3, np.float32), 1.0
    center = (lo + hi) * 0.5
    radius = float(np.linalg.norm(hi - center)) + 1e-3
    return center, radius


def render_shadow_map(geometry: GeometryBuffers, plan: DrawPlan,
                      params: DrawParams, light_cam: CameraParams,
                      palette: Array, size: int, skinned: bool,
                      raster: str = "pallas", corner_t=None,
                      tri_draw=None, draw_stride: int = 0,
                      real_draws: int = 0) -> Array:
    """Depth-only render from the light: (S,S) f32 in [0,1]. With a
    static corner table (ops/corner.py) the light-view setup is planar
    and gather-free, same as the main view."""
    if corner_t is not None and tri_draw is not None and not skinned:
        from trident.ops.corner import build_draw_rows, corner_stage

        draw_rows = build_draw_rows(params, light_cam, size, size)
        setup = corner_stage(corner_t, draw_rows, tri_draw, plan.tri_valid,
                             size, size, draw_stride=draw_stride,
                             real_draws=real_draws).setup
    else:
        verts = vertex_stage(geometry, plan, params, light_cam, palette,
                             skinned=skinned)
        setup = triangle_setup(verts.clip, plan.tri_vtx, plan.tri_valid,
                               size, size)
    from trident.core.platform import raster_interpret
    from trident.ops.raster import rasterize

    # depth-only: the light pass needs no winner ids (plain min merge,
    # bit-identical depth)
    return rasterize(setup, size, size, raster=raster,
                     interpret=raster_interpret(), depth_only=True).depth


def shadow_factor(shadow: ShadowParams, world: Array, pcf: bool = False) -> Array:
    """Per-pixel directional shadow term in [0,1]: 1 = lit.

    pcf=False: ONE gather, hard edges. pcf=True: 2×2 bilinear percentage-
    closer filtering (4 gathers) — each tap's depth comparison happens
    BEFORE the blend, so the penumbra is a fractional lit value rather
    than a blurred depth (which would be meaningless to compare against).
    """
    s = shadow.depth.shape[0]
    pos_h = jnp.concatenate(
        [world, jnp.ones((*world.shape[:-1], 1), world.dtype)], axis=-1)
    clip = jnp.matmul(pos_h, shadow.light_vp.T,
                      precision=jax.lax.Precision.HIGHEST)
    safe_w = jnp.where(jnp.abs(clip[..., 3:4]) < 1e-12, 1e-12, clip[..., 3:4])
    ndc = clip[..., :3] / safe_w
    u = (ndc[..., 0] + 1.0) * 0.5
    v = (ndc[..., 1] + 1.0) * 0.5
    depth = ndc[..., 2]
    inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1) & (depth <= 1.0)
    test_depth = depth - shadow.bias

    if not pcf:
        xi = jnp.clip((u * s).astype(jnp.int32), 0, s - 1)
        yi = jnp.clip((v * s).astype(jnp.int32), 0, s - 1)
        lit = jnp.where(test_depth > shadow.depth[yi, xi], 0.0, 1.0)
    else:
        fx = u * s - 0.5
        fy = v * s - 0.5
        x0 = jnp.floor(fx).astype(jnp.int32)
        y0 = jnp.floor(fy).astype(jnp.int32)
        wx = fx - x0.astype(jnp.float32)
        wy = fy - y0.astype(jnp.float32)
        x0c, x1c = jnp.clip(x0, 0, s - 1), jnp.clip(x0 + 1, 0, s - 1)
        y0c, y1c = jnp.clip(y0, 0, s - 1), jnp.clip(y0 + 1, 0, s - 1)

        def tap(yi, xi):
            return jnp.where(test_depth > shadow.depth[yi, xi], 0.0, 1.0)

        lit = ((tap(y0c, x0c) * (1 - wx) + tap(y0c, x1c) * wx) * (1 - wy)
               + (tap(y1c, x0c) * (1 - wx) + tap(y1c, x1c) * wx) * wy)

    lit = jnp.where(inside, lit, 1.0)
    return jnp.where(shadow.enabled, lit, 1.0)[..., None]


def null_shadow(size: int = 1) -> ShadowParams:
    return ShadowParams(depth=jnp.ones((size, size), jnp.float32),
                        light_vp=jnp.eye(4, dtype=jnp.float32),
                        enabled=jnp.asarray(False),
                        bias=jnp.asarray(2e-3, jnp.float32))
