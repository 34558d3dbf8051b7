"""Reference rasterizer: pure-jnp visibility pass.

Correctness oracle for the binned kernel (ops/raster.py) and the CPU-test
path. Evaluates
homogeneous edge functions for every (triangle-chunk × full frame) and keeps
the nearest-depth winner per pixel (early-Z semantics, LESS_OR_EQUAL with
later-triangle-wins ties — matching the reference pipeline's depth state,
Pipeline.cpp:549-725).

O(T × H × W): intended for goldens and small scenes; the binned kernel
(ops/raster.py) is the production path.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from trident.ops.vertex import TriangleSetup
from trident.render.types import GBuffer

Array = jax.Array


def visibility_ref(setup: TriangleSetup, width: int, height: int,
                   chunk: int = 64, depth_clear: float = 1.0,
                   y_offset=0) -> GBuffer:
    """Rasterize all triangles, returning per-pixel winner id + depth.
    `y_offset` (int or traced i32): pixel rows cover the global band
    [y_offset, y_offset+height) — for multi-chip banded rendering; edge/z/w
    stay global while setup.bbox is band-local (ops.vertex.
    band_slice_setup)."""
    t = setup.edge.shape[0]
    n_chunks = max(1, -(-t // chunk))
    pad = n_chunks * chunk - t

    edge = jnp.pad(setup.edge, ((0, pad), (0, 0), (0, 0)))
    z = jnp.pad(setup.z, ((0, pad), (0, 0)))
    w = jnp.pad(setup.w, ((0, pad), (0, 0)))
    valid = jnp.pad(setup.valid, (0, pad))
    bbox = jnp.pad(setup.bbox, ((0, pad), (0, 0)))
    rows = jnp.arange(height, dtype=jnp.int32)
    cols = jnp.arange(width, dtype=jnp.int32)

    ys = (jnp.arange(height, dtype=jnp.float32)
          + jnp.asarray(y_offset, jnp.float32) + 0.5)
    xs = jnp.arange(width, dtype=jnp.float32) + 0.5
    py, px = jnp.meshgrid(ys, xs, indexing="ij")      # (H,W)

    def body(carry, chunk_data):
        best_depth, best_tri = carry
        c_edge, c_z, c_w, c_valid, c_bbox, c_base = chunk_data

        # e_k(p) for all triangles in chunk: (C,3,H,W)
        e = (c_edge[:, :, 0, None, None] * px[None, None]
             + c_edge[:, :, 1, None, None] * py[None, None]
             + c_edge[:, :, 2, None, None])
        cover = jnp.all(e >= 0.0, axis=1)             # (C,H,W)
        # RATIONAL per-pixel depth, association pinned to the binned
        # kernel's (e0·z0 + e1·z1) + e2·z2 chains so winner decisions
        # match it to the ulp (an einsum's association is layout-
        # dependent). The affine z_k/det form is NOT an option here: not
        # self-normalizing, fails on subpixel triangles (see
        # TriangleSetup's numerics note).
        z_interp = ((e[:, 0] * c_z[:, 0, None, None]
                     + e[:, 1] * c_z[:, 1, None, None])
                    + e[:, 2] * c_z[:, 2, None, None])
        w_interp = ((e[:, 0] * c_w[:, 0, None, None]
                     + e[:, 1] * c_w[:, 1, None, None])
                    + e[:, 2] * c_w[:, 2, None, None])
        safe_w = jnp.where(jnp.abs(w_interp) < 1e-12, 1e-12, w_interp)
        depth = z_interp / safe_w
        # depth-range test in the SAME cross-multiplied form as the binned
        # kernel (raster._eval_triangle): with w>0 it equals
        # 0 ≤ z/w ≤ 1 mathematically, but the divided form can disagree by
        # one rounding step at the far plane (z/w rounding to exactly 1.0
        # while z > w) — the oracle must make the identical decision
        cover &= ((w_interp > 1e-12) & (z_interp >= 0.0)
                  & (z_interp <= w_interp))
        cover &= c_valid[:, None, None]
        # clip to the triangle's pixel bbox, as the binned kernel does: a
        # sliver's edge functions can all round positive along a line far
        # outside the triangle (band-local rows, like setup.bbox)
        cover &= ((cols[None, None, :] >= c_bbox[:, 0, None, None])
                  & (cols[None, None, :] < c_bbox[:, 2, None, None])
                  & (rows[None, :, None] >= c_bbox[:, 1, None, None])
                  & (rows[None, :, None] < c_bbox[:, 3, None, None]))
        depth = jnp.where(cover, depth, jnp.inf)

        # later triangle wins depth ties (LESS_OR_EQUAL): take LAST argmin
        rev = depth[::-1]
        idx_rev = jnp.argmin(rev, axis=0)             # first min in reversed
        c = depth.shape[0]
        idx = c - 1 - idx_rev                         # last min in original
        chunk_depth = jnp.take_along_axis(depth, idx[None], axis=0)[0]
        chunk_tri = c_base + idx

        better = chunk_depth <= best_depth            # new chunk wins ties
        best_depth = jnp.where(better, chunk_depth, best_depth)
        best_tri = jnp.where(better, chunk_tri.astype(jnp.int32), best_tri)
        return (best_depth, best_tri), None

    # tie the carry init to the inputs so its sharding/varying-axes match
    # the body output under shard_map (mesh-banded rendering)
    tie_f = edge[0, 0, 0] * 0.0
    init = (
        jnp.full((height, width), depth_clear, jnp.float32) + tie_f,
        jnp.full((height, width), -1, jnp.int32) + tie_f.astype(jnp.int32),
    )
    chunks = (
        edge.reshape(n_chunks, chunk, 3, 3),
        z.reshape(n_chunks, chunk, 3),
        w.reshape(n_chunks, chunk, 3),
        valid.reshape(n_chunks, chunk),
        bbox.reshape(n_chunks, chunk, 4),
        (jnp.arange(n_chunks) * chunk).astype(jnp.int32),
    )
    (best_depth, best_tri), _ = jax.lax.scan(body, init, chunks)
    best_depth = jnp.where(best_tri >= 0, best_depth, depth_clear)
    return GBuffer(tri_id=best_tri, depth=best_depth)


def unexplained_mismatches(setup, rt, rd, pt, pd, y_offset: int = 0,
                           tol: float = 32.0) -> list:
    """Winner mismatches between the oracle (rt, rd) and a kernel (pt, pd)
    that are NOT benign. Two kernels that fuse the edge/depth mul+add
    chains into fmas differently can flip a pixel that sits within an ulp
    of a decision boundary. Every mismatch must be one of:
      (a) a depth tie — both winning depths agree to a few ulps;
      (b) a cover-boundary flip — one side's winner evaluates within f32
          noise (`tol`·eps·term scale) of a cover constraint (an edge
          function, zi >= 0 or zi <= wi) at the pixel center, so the other
          side dropped it and fell through to a farther triangle.
    Returns [((y, x), oracle_tid, kernel_tid, oracle_d, kernel_d), ...]
    for the rest; rows are band-local, `y_offset` places them."""
    edge = np.asarray(setup.edge, np.float64)
    z = np.asarray(setup.z, np.float64)
    w = np.asarray(setup.w, np.float64)
    eps32 = np.float32(2.0) ** -24

    def near_boundary(tri, yy, xx):
        if tri < 0:
            return False
        pxc, pyc = xx + 0.5, yy + y_offset + 0.5
        a, b, c = edge[tri, :, 0], edge[tri, :, 1], edge[tri, :, 2]
        e = a * pxc + b * pyc + c                     # (3,)
        scale_e = np.abs(a * pxc) + np.abs(b * pyc) + np.abs(c)
        zi = float(e @ z[tri])
        wi = float(e @ w[tri])
        scale_i = float(np.abs(e) @ np.abs(z[tri]) + np.abs(e) @ np.abs(w[tri]))
        margins = list(np.abs(e) / np.maximum(scale_e, 1e-300))
        margins += [abs(zi) / max(scale_i, 1e-300),
                    abs(wi - zi) / max(scale_i, 1e-300)]
        return min(margins) <= tol * eps32

    bad = []
    for yy, xx in zip(*np.nonzero(rt != pt)):
        d_r, d_p = rd[yy, xx], pd[yy, xx]
        if abs(d_r - d_p) <= 4 * np.spacing(np.float32(max(abs(d_r),
                                                           abs(d_p)))):
            continue
        if near_boundary(rt[yy, xx], yy, xx) or \
           near_boundary(pt[yy, xx], yy, xx):
            continue
        bad.append(((int(yy), int(xx)), int(rt[yy, xx]), int(pt[yy, xx]),
                    float(d_r), float(d_p)))
    return bad
