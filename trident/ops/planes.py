"""Per-triangle attribute interpolation planes.

For homogeneous rasterization, any vertex attribute A interpolates as a
rational screen function: A(p) = (gA·p)/(g1·p) with p=(px,py,1), where
gA = Σ_k A_k·edge_k and g1 = Σ_k edge_k are per-TRIANGLE constants. Folding
per-draw shading state (color factor, material, texture slot) in as plane
constants lets the deferred pass fetch everything it needs about a pixel's
winning triangle with TWO packed row gathers, in place of the naive
edge-row + vertex-ids + 3 attribute rows + draw-row fetch chain.

Plane table layout, split into two (T,16) tables:
  A: g1(3) | gN.x(3) | gN.y(3) | gN.z(3) | gU(3) | pad
  B: gV(3) | color_factor(4) | metallic | roughness | ambient | slot |
     anchor_x | anchor_y | pad(3)
(vertex colors, when enabled, get a third table C: gR(3) gG(3) gB(3) pad)

The deferred pass evaluates every plane at p' = (px−anchor, py−anchor, 1).
In f32 mode the anchors are 0 (absolute pixels). f16 mode (64B→32B
gather rows) re-anchors each
triangle at its bbox corner snapped to 16px (exact in f16) and rescales all
six g-vectors by a shared per-triangle 1/max|component| — the rational
forms A(p)=gA·p/g1·p and the UV screen derivatives are invariant to a
common scale, and anchoring bounds the |p'| lever arm so f16's 10-bit
mantissa cancellation error stays at the sub-LSB level.

Structure note: per-attribute plane builds are explicit elementwise
chains (_plane_parts — a dot_general's rounding depends on precision and
layout, which once drifted the golden flavors). XLA CSEs repeated
attrs[tri_vtx] gathers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from trident.ops.vertex import TriangleSetup, VertexStageOut

Array = jax.Array


class AttributePlanes(NamedTuple):
    table_a: Array            # (T,16) f32
    table_b: Array            # (T,16) f32
    table_c: Optional[Array]  # (T,16) f32 or None (no vertex colors)


def _plane_parts(attr: Array, edge: Array) -> list:
    """Interpolation-plane coefficients out[t,c] = Σ_k attr[t,k]·edge[t,k,c]
    as three (T,) columns, association fixed at (k0·e0 + k1·e1) + k2·e2.

    Deliberately ELEMENTWISE, not einsum: a k=3 einsum goes through
    dot_general, whose rounding is contract-precision- (TF32 on the GPU)
    and layout-dependent, while IEEE mul/add in one fixed association is
    layout-independent by construction."""
    return [(attr[:, 0] * edge[:, 0, c] + attr[:, 1] * edge[:, 1, c])
            + attr[:, 2] * edge[:, 2, c] for c in range(3)]


def _g1_parts(edge: Array) -> list:
    """Σ_k edge[t,k,c] as three (T,) columns, association (e0+e1)+e2 —
    the denominator plane (attr ≡ 1), same fixed-order rationale as
    _plane_parts."""
    return [(edge[:, 0, c] + edge[:, 1, c]) + edge[:, 2, c]
            for c in range(3)]


def build_planes(setup: TriangleSetup, verts: VertexStageOut, tri_vtx: Array,
                 tri_draw: Array, shade_table: Array,
                 vertex_colors: bool = False,
                 f16: bool = False) -> AttributePlanes:
    corners = verts.attrs[tri_vtx]                 # gathers CSE'd by XLA
    return build_planes_corners(
        setup, corners[..., 3:6], corners[..., 6:8], tri_draw, shade_table,
        corner_col=corners[..., 8:11] if vertex_colors else None, f16=f16)


def build_planes_corners(setup: TriangleSetup, corner_nrm: Array,
                         corner_uv: Array, tri_draw: Array,
                         shade_table: Array,
                         corner_col: Optional[Array] = None,
                         f16: bool = False) -> AttributePlanes:
    """build_planes from pre-gathered per-corner attributes — pure
    per-triangle math, shardable over the triangle dim (multi-chip
    geometry phase)."""
    edge = setup.edge                              # (T,3,3)
    t = edge.shape[0]
    vertex_colors = corner_col is not None

    def plane(attr_per_vertex):                    # (T,3) values → (T,3) plane
        return jnp.stack(_plane_parts(attr_per_vertex, edge), axis=1)

    g1 = jnp.stack(_g1_parts(edge), axis=1)        # (T,3)

    gs = [g1, plane(corner_nrm[..., 0]), plane(corner_nrm[..., 1]),
          plane(corner_nrm[..., 2]),
          plane(corner_uv[..., 0]), plane(corner_uv[..., 1])]
    if vertex_colors:
        gs += [plane(corner_col[..., 0]), plane(corner_col[..., 1]),
               plane(corner_col[..., 2])]

    if f16:
        # re-anchor at the bbox corner (16px-snapped: exact in f16) and
        # rescale by a SHARED per-triangle factor — ratios are invariant.
        # Kept as per-vector elementwise chains (no (T,K,3) stack) so XLA
        # fuses the shift/abs/max/scale into the plane einsums instead of
        # round-tripping a materialized stack through HBM.
        ax = (setup.bbox[:, 0] // 16 * 16).astype(edge.dtype)   # (T,)
        ay = (setup.bbox[:, 1] // 16 * 16).astype(edge.dtype)
        gs = [jnp.concatenate(
            [g[:, 0:2],
             (g[:, 2] + g[:, 0] * ax + g[:, 1] * ay)[:, None]], axis=1)
            for g in gs]
        m = gs[0][:, 0] * 0.0
        for g in gs:
            m = jnp.maximum(m, jnp.max(jnp.abs(g), axis=1))
        s = 1.0 / jnp.maximum(m, 1e-30)                         # (T,)
        gs = [g * s[:, None] for g in gs]
        store = jnp.float16
    else:
        ax = ay = jnp.zeros((t,), edge.dtype)
        store = edge.dtype

    g1, g_nx, g_ny, g_nz, g_u, g_v = gs[:6]
    draw = shade_table[tri_draw]                   # (T,8)

    pad1 = jnp.zeros((t, 1), edge.dtype)
    table_a = jnp.concatenate([g1, g_nx, g_ny, g_nz, g_u, pad1], axis=1)
    table_b = jnp.concatenate(
        [g_v, draw, ax[:, None], ay[:, None],
         jnp.zeros((t, 3), edge.dtype)], axis=1)

    table_c = None
    if vertex_colors:
        table_c = jnp.concatenate(
            [gs[6], gs[7], gs[8], jnp.zeros((t, 7), edge.dtype)], axis=1)
        table_c = table_c.astype(store)
    return AttributePlanes(table_a=table_a.astype(store),
                           table_b=table_b.astype(store), table_c=table_c)
