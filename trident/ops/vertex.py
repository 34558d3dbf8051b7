"""Vertex stage: skinning + world/clip transforms as batched matmuls.

Replaces Default.vert (linear-blend skinning from the bone palette SSBO,
normal-matrix transform, UV atlas transform) and the per-draw push-constant
loop. All draws are processed in ONE batched pass: vertices are gathered
into an expanded instance space and transformed by their draw's matrices via
one einsum.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from trident.render.types import CameraParams, DrawParams, DrawPlan, GeometryBuffers

Array = jax.Array


class VertexStageOut(NamedTuple):
    clip: Array       # (TV,4) f32
    attrs: Array      # (TV,12) f32 packed: world(3) normal(3) uv(2) color(3) pad
    packed: Array     # (TV,16) f32: clip(4) normal(3) uv(2) color(3) pad —
                      # the ONE row later stages gather per triangle corner
    # convenience views (slices of attrs — same buffers after XLA CSE)
    world: Array      # (TV,3) f32
    normal: Array     # (TV,3) f32 — world-space, normalized
    uv: Array         # (TV,2) f32 — atlas-transformed
    color: Array      # (TV,3) f32


def _skin(positions: Array, normals: Array, bone_indices: Array,
          bone_weights: Array, palette: Array, bone_offset: Array,
          bone_count: Array) -> tuple[Array, Array]:
    """Linear-blend skinning, ≤4 influences (Default.vert:60-90 semantics:
    weight<=0 or index outside [0,bone_count) is skipped; draws with
    bone_count==0 pass through rigid)."""
    tv = positions.shape[0]
    valid = (bone_weights > 0.0) & (bone_indices >= 0) & (bone_indices < bone_count[:, None])
    w = jnp.where(valid, bone_weights, 0.0)                       # (TV,4)
    idx = jnp.clip(bone_offset[:, None] + bone_indices, 0, palette.shape[0] - 1)
    mats = palette[idx]                                           # (TV,4,4,4)
    skin_mat = jnp.einsum("vb,vbij->vij", w, mats,
                          precision=jax.lax.Precision.HIGHEST)  # (TV,4,4)
    rigid = bone_count <= 0                                       # (TV,)
    eye = jnp.broadcast_to(jnp.eye(4, dtype=positions.dtype), (tv, 4, 4))
    skin_mat = jnp.where(rigid[:, None, None], eye, skin_mat)
    pos_h = jnp.concatenate([positions, jnp.ones((tv, 1), positions.dtype)], axis=-1)
    hp = jax.lax.Precision.HIGHEST
    skinned_pos = jnp.einsum("vij,vj->vi", skin_mat, pos_h, precision=hp)[:, :3]
    skinned_nrm = jnp.einsum("vij,vj->vi", skin_mat[:, :3, :3], normals,
                             precision=hp)
    return skinned_pos, skinned_nrm


def _cofactor3(m: Array) -> Array:
    """Cofactor matrix of (...,3,3) — closed-form (rows are cross products),
    so normals transform as cof(M)·n ∝ (M⁻¹)ᵀ·n without LU decomposition
    (jnp.linalg.inv batched over 65k matrices is slow)."""
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    return jnp.stack([jnp.cross(r1, r2), jnp.cross(r2, r0), jnp.cross(r0, r1)],
                     axis=-2)


def vertex_stage(geometry: GeometryBuffers, plan: DrawPlan, params: DrawParams,
                 camera: CameraParams, palette: Array,
                 skinned: bool = True) -> VertexStageOut:
    """Transform all expanded vertices: gather → skin → model → view-proj.

    `palette` is the global bone-matrix table (P,4,4); unskinned scenes pass
    a (1,4,4) identity. `skinned=False` (static) compiles the rigid-only
    path with no palette gathers.
    """
    src = plan.vtx_src
    draw = plan.vtx_draw

    # ONE gather row per vertex for geometry, TWO for the draw transform
    row = geometry.attr_table[src]                                # (TV,12)
    positions = row[:, 0:3]
    normals = row[:, 3:6]
    uvs = row[:, 6:8]
    colors = row[:, 8:11]
    xa = params.xform_a[draw]                                     # (TV,12)
    xb = params.xform_b[draw]                                     # (TV,12)
    model = jnp.concatenate([xa, xb[:, 0:4]], axis=-1).reshape(-1, 4, 4)
    uv_scale = xb[:, 4:6]
    uv_offset = xb[:, 6:8]
    tiling = xb[:, 8:9]

    if skinned:
        bone_offset = params.bone_offset[draw]
        bone_count = params.bone_count[draw]
        skinned_pos, skinned_nrm = _skin(
            positions, normals,
            geometry.bone_indices[src], geometry.bone_weights[src],
            palette, bone_offset, bone_count,
        )
    else:
        skinned_pos, skinned_nrm = positions, normals

    tv = skinned_pos.shape[0]
    pos_h = jnp.concatenate([skinned_pos, jnp.ones((tv, 1), skinned_pos.dtype)], axis=-1)
    # Precision.HIGHEST everywhere positions flow: a reduced-precision
    # matmul (bf16, or TF32 on the GPU) quantizes world/clip coordinates
    # enough to put visible acne in the shadow depth comparison
    world_h = jnp.einsum("vij,vj->vi", model, pos_h,
                         precision=jax.lax.Precision.HIGHEST)
    world = world_h[:, :3]

    # normal matrix ∝ cofactor(mat3(model)) — direction preserved, renormalized
    cof = _cofactor3(model[:, :3, :3])
    nrm = jnp.einsum("vij,vj->vi", cof, skinned_nrm,
                     precision=jax.lax.Precision.HIGHEST)
    nrm = nrm * jax.lax.rsqrt(jnp.maximum(
        jnp.sum(nrm * nrm, axis=-1, keepdims=True), 1e-16))

    vp = camera.proj @ camera.view                                # (4,4)
    clip = jnp.matmul(world_h, vp.T,
                      precision=jax.lax.Precision.HIGHEST)  # (TV,4), one matmul

    uv = uvs * uv_scale * tiling + uv_offset

    attrs = jnp.concatenate(
        [world, nrm, uv, colors, jnp.zeros((tv, 1), world.dtype)], axis=-1)
    packed = jnp.concatenate(
        [clip, nrm, uv, colors, jnp.zeros((tv, 4), world.dtype)], axis=-1)
    return VertexStageOut(clip=clip, attrs=attrs, packed=packed, world=world,
                          normal=nrm, uv=uv, color=colors)


class TriangleSetup(NamedTuple):
    """Per-triangle rasterization constants for homogeneous (2DH) raster.

    edge: (T,3,3) — rows are edge-function coefficients (a,b,c) such that
          e_i(px,py) = a*px + b*py + c in PIXEL coordinates; e_i are the
          clip-space barycentrics scaled by det. All e_i>=0 inside a
          front-facing triangle.
    z:    (T,3) clip-space z per vertex
    w:    (T,3) clip-space w per vertex
    bbox: (T,4) i32 — pixel-space (x0,y0,x1,y1) inclusive-exclusive
    valid:(T,) bool — front-facing, non-degenerate, on-screen

    Numerics note (round-3 hardware lesson): depth MUST stay the
    per-pixel rational zi/wi. z_ndc is algebraically affine in screen
    space (Σ_k e_k(p)·z_k/det, the denominator Σ_k e_k(p)·w_k being the
    constant det), and folding 1/det at setup deletes 4 FMAs + a
    reciprocal per (triangle, pixel) — but the affine form is NOT
    self-normalizing: zi and wi share the e_k values INCLUDING their
    rounding noise, so the ratio stays inside [min, max] of the vertex
    z_k/w_k no matter how noisy the tiny-triangle edge evaluation gets,
    while Σ e_k·(z_k/det) passes that noise straight through: at 1M
    subpixel triangles with ZO far-depth compression (all z/w near 1)
    the affine form leaves [0, 1] and its d>1 test culls covered
    pixels.
    """

    edge: Array
    z: Array
    w: Array
    bbox: Array
    valid: Array


class SetupCols(NamedTuple):
    """Planar twin of TriangleSetup's stacked arrays: the SAME values as
    (T,) column vectors, before any stack/reshape. Consumers on the hot
    path (record builders) slice TriangleSetup.edge/z right back into
    columns — handing them these instead keeps the whole geometry chain
    planar and lets XLA DCE the stacked intermediates entirely.

    e[3k+c] == TriangleSetup.edge[:, k, c]; z[k] == TriangleSetup.z[:, k];
    w[k] == TriangleSetup.w[:, k].
    """

    e: tuple      # 9 (T,) edge-coefficient columns
    z: tuple      # 3 (T,) clip-z columns
    w: tuple      # 3 (T,) clip-w columns


def planar_setup(sx, sy, ws, zs, tri_valid: Array,
                 width: int, height: int) -> TriangleSetup:
    """Stacked-only wrapper of planar_setup_cols (see there)."""
    return planar_setup_cols(sx, sy, ws, zs, tri_valid, width, height)[0]


def planar_setup_cols(sx, sy, ws, zs, tri_valid: Array, width: int,
                      height: int) -> Tuple[TriangleSetup, SetupCols]:
    """Edge functions / winding / bbox / validity from planar per-corner
    lists (each a 3-list of (T,) vectors; sx/sy are viewport-scaled
    homogeneous coords, ws/zs clip w and z). The SINGLE implementation of
    the raster-setup numerics: the indexed path (triangle_setup) and the
    corner-major path (ops/corner.corner_stage) must make bit-identical
    cover/winding decisions, so every epsilon lives only here.

    Returns the stacked TriangleSetup AND the planar SetupCols holding
    the identical column values — callers that keep consuming columns
    never pay the (T,3,3) stack."""
    t = ws[0].shape[0]

    def cross(j, k):  # adjugate row i = cross(vertex_j, vertex_k), planar
        return (sy[j] * ws[k] - ws[j] * sy[k],
                ws[j] * sx[k] - sx[j] * ws[k],
                sx[j] * sy[k] - sy[j] * sx[k])

    e0 = cross(1, 2)                     # e = (a,b,c) with p = (px,py,1)
    e1 = cross(2, 0)
    e2 = cross(0, 1)
    det = sx[0] * e0[0] + sy[0] * e0[1] + ws[0] * e0[2]

    # Vulkan front face: counter-clockwise in framebuffer coords. With the
    # Y-flip proj + y-down pixel mapping, CCW-wound geometry yields
    # det > 0 for camera-facing triangles (validated by the cube golden).
    front = det > 1e-12

    # bbox in pixels, from NDC projections of vertices with w>0. Triangles
    # crossing w<=0 (near plane) get a conservative full-screen bbox.
    safe_w = [jnp.where(jnp.abs(w) < 1e-8, 1e-8, w) for w in ws]
    px = [s / w for s, w in zip(sx, safe_w)]
    py = [s / w for s, w in zip(sy, safe_w)]
    any_behind = (ws[0] <= 1e-6) | (ws[1] <= 1e-6) | (ws[2] <= 1e-6)
    min3 = lambda v: jnp.minimum(jnp.minimum(v[0], v[1]), v[2])
    max3 = lambda v: jnp.maximum(jnp.maximum(v[0], v[1]), v[2])
    x0 = jnp.where(any_behind, 0.0, jnp.floor(min3(px)))
    y0 = jnp.where(any_behind, 0.0, jnp.floor(min3(py)))
    x1 = jnp.where(any_behind, float(width), jnp.ceil(max3(px)) + 1.0)
    y1 = jnp.where(any_behind, float(height), jnp.ceil(max3(py)) + 1.0)
    x0 = jnp.clip(x0, 0, width).astype(jnp.int32)
    y0 = jnp.clip(y0, 0, height).astype(jnp.int32)
    x1 = jnp.clip(x1, 0, width).astype(jnp.int32)
    y1 = jnp.clip(y1, 0, height).astype(jnp.int32)
    bbox = jnp.stack([x0, y0, x1, y1], axis=-1)

    on_screen = (x1 > x0) & (y1 > y0)
    valid = tri_valid & front & on_screen

    edge = jnp.stack([*e0, *e1, *e2], axis=-1).reshape(t, 3, 3)
    z = jnp.stack(zs, axis=-1)
    w = jnp.stack(ws, axis=-1)
    return (TriangleSetup(edge=edge, z=z, w=w, bbox=bbox, valid=valid),
            SetupCols(e=(*e0, *e1, *e2), z=tuple(zs), w=tuple(ws)))


def triangle_setup(clip: Array, tri_vtx: Array, tri_valid: Array,
                   width: int, height: int) -> TriangleSetup:
    """Compute homogeneous edge functions in pixel space.

    NDC→pixel: px = (ndc_x+1)/2*W, py = (ndc_y+1)/2*H (row 0 = top, matching
    Vulkan's y-down framebuffer with the projection Y-flip baked in). We fold
    that viewport transform into the homogeneous coords so edge functions are
    evaluated directly at pixel centers.

    `clip` is (V,4) with `tri_vtx` (T,3) indices, or pre-gathered (T,3,4)
    corner clip coords with tri_vtx=None (shared-gather fast path).

    Internally PLANAR: the corner block is transposed ONCE to (12,T) and
    every cross product / min / max runs on (T,) vectors. The public
    (T,3,3)/(T,3)/(T,4) output shapes are unchanged — inside a fused frame
    graph XLA folds the final stack into consumers' column slices.
    """
    c = clip if tri_vtx is None else clip[tri_vtx]   # (T,3,4)
    t = c.shape[0]
    ct = c.reshape(t, 12).T                          # (12,T) — one relayout
    xs = [ct[0], ct[4], ct[8]]
    ys = [ct[1], ct[5], ct[9]]
    zs = [ct[2], ct[6], ct[10]]
    ws = [ct[3], ct[7], ct[11]]

    # viewport-scaled homogeneous coords: sx = (x + w)*W/2, sy = (y + w)*H/2
    # (so sx/w = pixel x). Keep w as third coord.
    sx = [(x + w) * (0.5 * width) for x, w in zip(xs, ws)]
    sy = [(y + w) * (0.5 * height) for y, w in zip(ys, ws)]
    return planar_setup(sx, sy, ws, zs, tri_valid, width, height)


def band_slice_setup(setup: TriangleSetup, y0, band_h: int) -> TriangleSetup:
    """Restrict a FULL-FRAME triangle setup to the horizontal pixel band
    [y0, y0+band_h): bboxes shift to band-local coordinates and triangles
    that miss the band go invalid — the per-band geometry cull of the
    multi-chip path (parallel/framebuffer.py). edge/z/w stay in global
    pixel coordinates; the rasterizers take the matching y offset so band
    arithmetic is bit-identical to the single-chip render. `y0` may be a
    traced i32 scalar (device index × band height under shard_map)."""
    by0 = jnp.clip(setup.bbox[:, 1] - y0, 0, band_h)
    by1 = jnp.clip(setup.bbox[:, 3] - y0, 0, band_h)
    bbox = jnp.stack([setup.bbox[:, 0], by0, setup.bbox[:, 2], by1], axis=-1)
    return TriangleSetup(edge=setup.edge, z=setup.z, w=setup.w, bbox=bbox,
                         valid=setup.valid & (by1 > by0))
