"""Corner-major geometry path: zero per-frame geometry gathers.

The indexed pipeline (ops/vertex.py) gathers TV attribute rows in the
vertex stage plus 3T corner rows for setup/planes before any math. This
path trades memory for gathers: the EXPANDED corner table
(T, 3 corners, pos+nrm+uv+col) is built once per draw-plan topology,
kept on device pre-transposed to (36, T) so every per-frame operation is
planar math, and the only per-frame gather is ONE (T, 32) row of
per-draw constants:

    draw_row = [ (P·V·M row0+row3)·W/2 | (row1+row3)·H/2 | row3 | row2 |
                 cof(M) | uv_scale·tiling | uv_offset | pad ]

i.e. the viewport transform, clip rows, normal matrix and UV transform
are all folded per DRAW (D tiny) inside the jit, then broadcast to
triangles by the single tri_draw gather. Rigid draws only — skinned
scenes keep the indexed path (palette gathers are per-vertex by nature).

Static cost: 144 MB of device memory per 1M-triangle topology (cached by
DrawPlanCache version).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from trident.ops.vertex import TriangleSetup, _cofactor3, planar_setup
from trident.render.types import CameraParams, DrawParams

Array = jax.Array

DRAW_ROW = 32        # 29 transform/normal/uv floats + pad


def build_corner_table(attr_table: np.ndarray, vtx_src: np.ndarray,
                       tri_vtx: np.ndarray) -> np.ndarray:
    """(36, T) f32 planar corner table: for each corner k∈{0,1,2}, rows
    12k..12k+11 hold pos(3) nrm(3) uv(2) col(3) pad. Host-side, once per
    topology (DrawPlanCache caches the device upload)."""
    src_corner = np.asarray(vtx_src)[np.asarray(tri_vtx)]       # (T,3)
    corners = np.asarray(attr_table)[src_corner]                # (T,3,12)
    t = corners.shape[0]
    return np.ascontiguousarray(
        corners.reshape(t, 36).T.astype(np.float32))


def build_draw_rows(params: DrawParams, camera: CameraParams,
                    width: int, height: int) -> Array:
    """(D, 32) per-draw constant rows (in-jit; D is tiny)."""
    hp = jax.lax.Precision.HIGHEST
    d = params.xform_a.shape[0]
    model = jnp.concatenate([params.xform_a, params.xform_b[:, 0:4]],
                            axis=-1).reshape(d, 4, 4)
    vp = jnp.matmul(camera.proj, camera.view, precision=hp)
    mvp = jnp.einsum("ij,djk->dik", vp, model, precision=hp)    # (D,4,4)
    row_sx = (mvp[:, 0, :] + mvp[:, 3, :]) * (0.5 * width)
    row_sy = (mvp[:, 1, :] + mvp[:, 3, :]) * (0.5 * height)
    row_w = mvp[:, 3, :]
    row_z = mvp[:, 2, :]
    cof = _cofactor3(model[:, :3, :3]).reshape(d, 9)
    uv_scale = params.xform_b[:, 4:6] * params.xform_b[:, 8:9]
    uv_offset = params.xform_b[:, 6:8]
    return jnp.concatenate([
        row_sx, row_sy, row_w, row_z, cof, uv_scale, uv_offset,
        jnp.zeros((d, 3), jnp.float32)], axis=1)


class CornerStageOut(NamedTuple):
    setup: TriangleSetup
    corner_nrm: Array          # (T,3,3) world-space, normalized
    corner_uv: Array           # (T,3,2) atlas-transformed
    corner_col: Optional[Array]  # (T,3,3) or None


def corner_stage(corner_t: Array, draw_rows: Array, tri_draw: Array,
                 tri_valid: Array, width: int, height: int,
                 vertex_colors: bool = False,
                 draw_stride: int = 0, real_draws: int = 0) -> CornerStageOut:
    """Planar triangle setup + world corner attributes from the static
    corner table. ONE gather (draw_rows[tri_draw]); everything else runs
    on (T,) lanes. Matches ops/vertex.vertex_stage + triangle_setup
    semantics for rigid draws (Default.vert minus skinning).

    `draw_stride` > 0 (static) declares the UNIFORM plan layout: draw d
    owns triangles [d·stride, (d+1)·stride) for d < real_draws, the rest
    is padding (tri_valid False). The per-triangle draw-row lookup then
    becomes a broadcast + minor-dim reshape — a layout no-op XLA fuses
    into the planar math, deleting the (T,48) gather that instanced
    scenes otherwise pay every frame.
    DrawPlanCache.draw_stride computes this host-side (one mesh repeated
    over all draws — the instancing case)."""
    t = corner_t.shape[1]
    if draw_stride > 0:
        used_t = draw_rows[:real_draws].T           # (48, D) — tiny
        body = jnp.broadcast_to(
            used_t[:, :, None], (DRAW_ROW, real_draws, draw_stride)
        ).reshape(DRAW_ROW, real_draws * draw_stride)
        pad = t - real_draws * draw_stride
        if pad < 0:
            raise ValueError(
                f"draw_stride {draw_stride} x real_draws {real_draws} "
                f"exceeds the corner table's {t} triangles")
        if pad:
            xt = jnp.concatenate(
                [body, jnp.broadcast_to(draw_rows[0:1].T, (DRAW_ROW, pad))],
                axis=1)
        else:
            xt = body
    else:
        xt = draw_rows[tri_draw].T                  # (32,T) — THE gather

    def g(j):
        return xt[j]

    sx, sy, wz, zz = [], [], [], []
    nrm_cols, uv_cols, col_cols = [], [], []
    for k in range(3):
        px, py, pz = corner_t[12 * k], corner_t[12 * k + 1], corner_t[12 * k + 2]
        sx.append(g(0) * px + g(1) * py + g(2) * pz + g(3))
        sy.append(g(4) * px + g(5) * py + g(6) * pz + g(7))
        wz.append(g(8) * px + g(9) * py + g(10) * pz + g(11))
        zz.append(g(12) * px + g(13) * py + g(14) * pz + g(15))
        # world normal = cof(M)·n, renormalized (vertex.py:107-110)
        nx0, ny0, nz0 = (corner_t[12 * k + 3], corner_t[12 * k + 4],
                         corner_t[12 * k + 5])
        nx = g(16) * nx0 + g(17) * ny0 + g(18) * nz0
        ny = g(19) * nx0 + g(20) * ny0 + g(21) * nz0
        nz = g(22) * nx0 + g(23) * ny0 + g(24) * nz0
        inv = jax.lax.rsqrt(jnp.maximum(nx * nx + ny * ny + nz * nz, 1e-16))
        nrm_cols += [nx * inv, ny * inv, nz * inv]
        uv_cols += [corner_t[12 * k + 6] * g(25) + g(27),
                    corner_t[12 * k + 7] * g(26) + g(28)]
        if vertex_colors:
            col_cols += [corner_t[12 * k + 8], corner_t[12 * k + 9],
                         corner_t[12 * k + 10]]

    # the edge/winding/bbox numerics are SHARED with the indexed path
    # (ops/vertex.planar_setup) — both must make bit-identical decisions
    setup = planar_setup(sx, sy, wz, zz, tri_valid, width, height)
    corner_nrm = jnp.stack(nrm_cols, axis=-1).reshape(t, 3, 3)
    corner_uv = jnp.stack(uv_cols, axis=-1).reshape(t, 3, 2)
    corner_col = (jnp.stack(col_cols, axis=-1).reshape(t, 3, 3)
                  if vertex_colors else None)
    return CornerStageOut(setup=setup, corner_nrm=corner_nrm,
                          corner_uv=corner_uv, corner_col=corner_col)
