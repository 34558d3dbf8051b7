"""Production visibility pass: tile-binned rasterization for the GPU.

Replaces the O(T×pixels) reference path (ops/raster_ref.py) with a
sort-middle design:

  1. (XLA) Triangle records are packed (Tpad+C, 20) row-major — 9
     homogeneous edge coefficients, clip z and w per vertex, the pixel
     bbox — in chunks of C consecutive triangles. Meshes are Morton-ordered at build time
     (geometry.mesh.morton_order), so a chunk's union bbox is tight.
     Records chunk slot 0 is an empty sentinel.
  2. (XLA) Each chunk is binned to the framebuffer tiles its bbox overlaps:
     small chunks emit a span0² window of candidate tiles, wider chunks
     cascade through windowed mid tiers, and whales broadcast against
     every tile. Pairs pack as (tile | chunk slot) in ONE sortable i32, so
     one sort yields the tile-major pair list. Every surviving pair is
     tested against its chunk's SUB-triangle sub-block bboxes, and the hit
     sub-blocks flatten into one tile-major entry list with a CSR offset
     array `off` (tile t owns entries [off[t], off[t+1])).
  3. (Pallas, Triton) One program per screen tile walks its own entry
     range with a dynamic loop, evaluates each sub-block's triangles
     against the tile's pixels, and keeps the early-Z winner (depth, tid)
     in registers. It writes its tile once; nothing carries between
     programs.

The merge is ORDER-INDEPENDENT lexicographic (min depth, max triangle id
on ties) — the reference pipeline's LESS_OR_EQUAL later-draw-wins state
(Pipeline.cpp:549-725) for any processing order.

Capacity overflow (pairs beyond PAIR_BUDGET, whale chunks beyond
MAX_GLOBAL) degrades to MISSING geometry, never to garbage; the per-frame
drop counts ride out in GBuffer.aux → FrameOutput.aux so the renderer can
warn.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from trident.ops.vertex import TriangleSetup
from trident.render.types import GBuffer

Array = jax.Array

TILE_H = 32          # screen tile: one Triton program, 1024 pixels
TILE_W = 32
NPX = TILE_H * TILE_W
CHUNK = 256          # triangles per binned chunk
SUB = 16             # triangles per hit-tested sub-block
NSUB = CHUNK // SUB
SPAN0 = 2            # base-tier span (tiles per axis) at 1080p
MAX_GLOBAL = 8       # whale-chunk slots; overflow is counted in aux[1]
MID_CAPS = (1024, 128, 32, 8)
                     # cascading mid tiers: tier k admits up to MID_CAPS[k]
                     # chunks whose tile span fits a (span0<<(k+1))² window
                     # anchored at their bbox corner; chunks past a cap
                     # fall through to the next tier, then to the whales
PAIR_BUDGET = 65536  # real pairs kept per frame; overflow counted in aux[0]
NUM_WARPS = 4        # 1024 pixels over 128 threads: 8 pixels a thread


REC_W = 20           # record row: edges 0-8, z 9-11, w 12-14, bbox 15-18


class Bins(NamedTuple):
    records: Array      # ((NC+1)*C, REC_W) f32; chunk slot 0 = empty
    off: Array          # (n_tiles+1,) i32 CSR offsets into the entry list
    ent_row: Array      # (NE,) i32 first record row of each hit sub-block
    ent_tile: Array     # (NE,) i32 tile of each entry (n_tiles = padding)
    n_ent: Array        # () i32 real entries (sorted prefix)
    aux: Array          # (2,) i32 [truncated real pairs, dropped whales]


def _build_records(setup: TriangleSetup, tpad: int) -> Array:
    t = setup.edge.shape[0]
    valid = setup.valid
    cols = []
    for k in range(3):  # e_k = a*px + b*py + c ; invalid triangles get e ≡ -1
        cols.append(jnp.where(valid, setup.edge[:, k, 0], 0.0))
        cols.append(jnp.where(valid, setup.edge[:, k, 1], 0.0))
        cols.append(jnp.where(valid, setup.edge[:, k, 2], -1.0))
    for k in range(3):
        cols.append(jnp.where(valid, setup.z[:, k], 0.0))
    for k in range(3):
        cols.append(jnp.where(valid, setup.w[:, k], 1.0))
    for k in range(4):              # pixel bbox, exact in f32 (< 2^24)
        cols.append(jnp.where(valid, setup.bbox[:, k], 0).astype(jnp.float32))
    cols.append(jnp.zeros((t,), jnp.float32))          # pad
    rec = jnp.stack(cols, axis=1)                       # (T, REC_W)
    empty_row = jnp.zeros((REC_W,), rec.dtype)
    empty_row = empty_row.at[2].set(-1.0).at[5].set(-1.0).at[8].set(-1.0)
    empty_row = empty_row.at[12:15].set(1.0)
    # sentinel chunk 0 in front + tail padding; neither ever covers a pixel
    parts = [jnp.tile(empty_row, (CHUNK, 1)), rec]
    if tpad != t:
        parts.append(jnp.tile(empty_row, (tpad - t, 1)))
    return jnp.concatenate(parts, axis=0)


def tile_offsets(ent_tile: Array, n_tiles: int) -> Array:
    """CSR offsets of a tile-sorted entry list: tile t owns entries
    [off[t], off[t+1]). Padding entries carry tile id n_tiles, so
    off[n_tiles] is the real entry count."""
    return jnp.searchsorted(
        ent_tile, jnp.arange(n_tiles + 1, dtype=jnp.int32),
        side="left").astype(jnp.int32)


def build_bins(setup: TriangleSetup, width: int, height: int) -> Bins:
    """Bin the frame's triangles to TILE_H×TILE_W tiles (width/height are
    whole multiples of the tile). Returns the record table and the
    tile-major CSR list of (tile, hit sub-block) entries."""
    t = setup.edge.shape[0]
    n_chunks = max(1, -(-t // CHUNK))
    tpad = n_chunks * CHUNK
    ntx = -(-width // TILE_W)
    nty = -(-height // TILE_H)
    n_tiles = ntx * nty
    cbits = max(1, n_chunks.bit_length())     # chunk slots 0..n_chunks
    tbits = max(1, n_tiles.bit_length())      # sentinel tile id == n_tiles
    if tbits + cbits > 31:
        raise ValueError(
            f"framebuffer {width}x{height} ({n_tiles} raster tiles) with "
            f"{t} triangles ({n_chunks} chunks) exceeds the 31-bit packed-"
            "pair key. Render in bands (parallel.framebuffer), lower "
            "supersample/resolution, or split the scene across draws.")

    records = _build_records(setup, tpad)

    # chunk and sub-block union bboxes (pixel space, x0/y0 incl, x1/y1 excl)
    bbox = setup.bbox
    valid = setup.valid
    if tpad != t:
        empty = jnp.tile(jnp.asarray([1 << 20, 1 << 20, 0, 0], jnp.int32),
                         (tpad - t, 1))
        bbox = jnp.concatenate([bbox, empty], axis=0)
        valid = jnp.concatenate([valid, jnp.zeros(tpad - t, bool)])
    big = jnp.asarray(1 << 20, jnp.int32)
    qx0 = jnp.where(valid, bbox[:, 0], big).reshape(n_chunks, NSUB, SUB).min(2)
    qy0 = jnp.where(valid, bbox[:, 1], big).reshape(n_chunks, NSUB, SUB).min(2)
    qx1 = jnp.where(valid, bbox[:, 2], 0).reshape(n_chunks, NSUB, SUB).max(2)
    qy1 = jnp.where(valid, bbox[:, 3], 0).reshape(n_chunks, NSUB, SUB).max(2)
    x0, y0 = qx0.min(axis=1), qy0.min(axis=1)
    x1, y1 = qx1.max(axis=1), qy1.max(axis=1)
    nonempty = (x1 > x0) & (y1 > y0)
    ctx0 = jnp.clip(x0 // TILE_W, 0, ntx - 1)
    cty0 = jnp.clip(y0 // TILE_H, 0, nty - 1)
    span_x = jnp.clip((x1 - 1) // TILE_W, 0, ntx - 1) - ctx0 + 1
    span_y = jnp.clip((y1 - 1) // TILE_H, 0, nty - 1) - cty0 + 1

    # per sub-block tile bboxes: every candidate tile is tested against
    # these exactly (empty sub-block = never hits)
    q_nonempty = (qx1 > qx0) & (qy1 > qy0)                       # (NC, NSUB)
    qty0 = jnp.where(q_nonempty, jnp.clip(qy0 // TILE_H, 0, nty - 1), 32767)
    qty1 = jnp.where(q_nonempty, jnp.clip((qy1 - 1) // TILE_H, 0, nty - 1), -1)
    qtx0 = jnp.where(q_nonempty, jnp.clip(qx0 // TILE_W, 0, ntx - 1), 32767)
    qtx1 = jnp.where(q_nonempty, jnp.clip((qx1 - 1) // TILE_W, 0, ntx - 1), -1)

    def pack_keys(tile_arr, slot_col):
        return ((tile_arr << cbits) | slot_col).astype(jnp.int32)

    def subblock_hit(ty, tx, sel=None):
        """Does ANY sub-block bbox of the chunk touch the candidate tile?
        `sel` restricts the test to a compacted chunk subset."""
        q0, q1 = (qty0, qty1) if sel is None else (qty0[sel], qty1[sel])
        x0_, x1_ = (qtx0, qtx1) if sel is None else (qtx0[sel], qtx1[sel])
        hit = ((ty[..., None] >= q0[:, None, :])
               & (ty[..., None] <= q1[:, None, :])
               & (tx[..., None] >= x0_[:, None, :])
               & (tx[..., None] <= x1_[:, None, :]))             # (·,K,NSUB)
        return jnp.any(hit, axis=-1)

    # the base span scales with the frame's tile extent (static per shape):
    # a chunk's pixel footprint grows with resolution while tiles stay
    # 32 px, so 4K/SSAA frames would otherwise cascade into whale drops
    f = 1
    while ntx > 68 * f or nty > 40 * f:
        f *= 2
    span0 = SPAN0 * f
    slot_ids = jnp.arange(1, n_chunks + 1, dtype=jnp.int32)
    sentinel = jnp.asarray(n_tiles << cbits, jnp.int32)

    # small chunks → up to span0×span0 (tile, chunk) pairs
    small = nonempty & (span_x <= span0) & (span_y <= span0)
    k = span0 * span0
    dx = jnp.arange(k, dtype=jnp.int32) % span0
    dy = jnp.arange(k, dtype=jnp.int32) // span0
    tx = ctx0[:, None] + dx[None, :]
    ty = cty0[:, None] + dy[None, :]
    in_range = small[:, None] & subblock_hit(ty, tx)
    parts = [jnp.where(in_range, pack_keys(ty * ntx + tx, slot_ids[:, None]),
                       sentinel).reshape(-1)]
    # wider chunks cascade through the windowed mid tiers
    admitted = small
    wx = wy = span0
    for cap in MID_CAPS:
        wx, wy = wx * 2, wy * 2
        fits = nonempty & ~admitted & (span_x <= wx) & (span_y <= wy)
        gsel = jnp.argsort(~fits, stable=True).astype(jnp.int32)
        gsel = gsel[:min(cap, n_chunks)]
        gvalid = fits[gsel]
        admitted = admitted | jnp.zeros(n_chunks, bool).at[gsel].set(gvalid)
        kk = wx * wy
        tx = ctx0[gsel][:, None] + (jnp.arange(kk, dtype=jnp.int32) % wx)
        ty = cty0[gsel][:, None] + (jnp.arange(kk, dtype=jnp.int32) // wx)
        m = gvalid[:, None] & subblock_hit(ty, tx, gsel)
        parts.append(jnp.where(
            m, pack_keys(ty * ntx + tx, slot_ids[gsel][:, None]),
            sentinel).reshape(-1))
    # whale chunks: broadcast against every tile; past the cap they are
    # DROPPED (missing geometry) and counted in aux[1]
    gmask = nonempty & ~admitted
    gsel = jnp.argsort(~gmask, stable=True).astype(jnp.int32)
    gsel = gsel[:min(MAX_GLOBAL, n_chunks)]
    gvalid = gmask[gsel]
    n_big_dropped = (jnp.sum(gmask) - jnp.sum(gvalid)).astype(jnp.int32)
    tile_ids = jnp.arange(n_tiles, dtype=jnp.int32)
    g_ty = jnp.broadcast_to(tile_ids[None, :] // ntx, (gsel.shape[0], n_tiles))
    g_tx = jnp.broadcast_to(tile_ids[None, :] % ntx, (gsel.shape[0], n_tiles))
    big_mask = gvalid[:, None] & subblock_hit(g_ty, g_tx, gsel)
    parts.append(jnp.where(
        big_mask, pack_keys(tile_ids[None, :], gsel[:, None] + 1),
        sentinel).reshape(-1))

    # one sort orders AND compacts: real pairs form the sorted prefix
    pairs = jnp.sort(jnp.concatenate(parts))
    n_real_total = jnp.sum(pairs < sentinel).astype(jnp.int32)
    if pairs.shape[0] > PAIR_BUDGET:
        pairs = pairs[:PAIR_BUDGET]
    n_real = jnp.minimum(n_real_total, pairs.shape[0])
    pair_tile = pairs >> cbits
    pair_chunk = pairs & ((1 << cbits) - 1)

    # each surviving pair's hit sub-blocks (sentinel chunk 0 never hits),
    # flattened pair-major — which keeps the tile order — and compacted
    qtab = jnp.concatenate([
        jnp.stack([jnp.full((1, NSUB), 32767, jnp.int32),
                   jnp.full((1, NSUB), -1, jnp.int32),
                   jnp.full((1, NSUB), 32767, jnp.int32),
                   jnp.full((1, NSUB), -1, jnp.int32)], axis=1),
        jnp.stack([qty0, qty1, qtx0, qtx1], axis=1).astype(jnp.int32),
    ], axis=0)                                       # (NC+1, 4, NSUB)
    rows = qtab[pair_chunk]                          # (NPAIR, 4, NSUB)
    p_ty = (pair_tile // ntx)[:, None]
    p_tx = (pair_tile % ntx)[:, None]
    real = jnp.arange(pairs.shape[0], dtype=jnp.int32) < n_real
    hit = (real[:, None] & (p_ty >= rows[:, 0]) & (p_ty <= rows[:, 1])
           & (p_tx >= rows[:, 2]) & (p_tx <= rows[:, 3])).reshape(-1)
    sub_row = (pair_chunk[:, None] * CHUNK
               + jnp.arange(NSUB, dtype=jnp.int32)[None, :] * SUB).reshape(-1)
    sub_tile = jnp.broadcast_to(pair_tile[:, None], (pairs.shape[0], NSUB))
    cap = hit.shape[0]
    pos = jnp.where(hit, jnp.cumsum(hit.astype(jnp.int32)) - 1, cap)
    ent_row = jnp.zeros((cap,), jnp.int32).at[pos].set(sub_row, mode="drop")
    ent_tile = jnp.full((cap,), n_tiles, jnp.int32).at[pos].set(
        sub_tile.reshape(-1), mode="drop")
    return Bins(records=records, off=tile_offsets(ent_tile, n_tiles),
                ent_row=ent_row, ent_tile=ent_tile,
                n_ent=jnp.sum(hit).astype(jnp.int32),
                aux=jnp.stack([n_real_total - n_real, n_big_dropped]))


def _tile_pixels(tile, ntx: int, y0):
    """Pixel-center coordinates of a tile's NPX pixels (row-major within
    the tile): x, global y, and y local to the band whose top is global
    pixel row `y0` (multi-chip bands). Every value is an integer + 0.5,
    exact in f32, so a band's rows equal the full frame's bit for bit."""
    r = jax.lax.broadcasted_iota(jnp.int32, (NPX,), 0)
    ty = tile // ntx
    tx = jax.lax.rem(tile, ntx)
    px = (tx * TILE_W + jax.lax.rem(r, TILE_W)).astype(jnp.float32) + 0.5
    pyl = (ty * TILE_H + r // TILE_W).astype(jnp.float32) + 0.5
    return px, pyl + y0.astype(jnp.float32), pyl


def _eval_triangle(c, px, py, pyl):
    """Coverage and depth of one triangle record `c` (REC_W values) at
    pixel centers. Numerics pinned to raster_ref.visibility_ref: the same
    association of the edge and rational depth chains, the depth-range
    test in cross-multiplied form, and coverage clipped to the triangle's
    pixel bbox (band-local rows: `pyl`) — a sliver's edge functions can
    all round positive along a line far outside the triangle."""
    e0 = c[0] * px + c[1] * py + c[2]
    e1 = c[3] * px + c[4] * py + c[5]
    e2 = c[6] * px + c[7] * py + c[8]
    zi = (e0 * c[9] + e1 * c[10]) + e2 * c[11]
    wi = (e0 * c[12] + e1 * c[13]) + e2 * c[14]
    mnn = jnp.minimum(jnp.minimum(e0, e1), jnp.minimum(e2, zi))
    inside = ((px > c[15]) & (px < c[17]) & (pyl > c[16]) & (pyl < c[18]))
    cover = (mnn >= 0.0) & (zi <= wi) & (wi > 1e-12) & inside
    return cover, zi / jnp.where(cover, wi, 1.0)


def _visibility_kernel(off_ref, ent_ref, rec_ref, y0_ref, depth_ref,
                       *tri_ref, ntx: int):
    """One program per tile: loop over the tile's CSR entry range, each
    entry a SUB-triangle sub-block; the (depth, tid) winner stays in
    registers and is stored once. Without a tri output (the shadow pass)
    the merge is a plain depth min — bit-identical depth."""
    tile = pl.program_id(0)
    px, py, pyl = _tile_pixels(tile, ntx, y0_ref[0])
    depth_only = not tri_ref

    def entry(k, carry):
        row0 = ent_ref[k]
        for j in range(SUB):
            row = row0 + j
            cover, d = _eval_triangle(
                [rec_ref[row, i] for i in range(REC_W - 1)], px, py, pyl)
            if depth_only:
                carry = jnp.where(cover, jnp.minimum(carry, d), carry)
                continue
            acc_d, acc_t = carry
            tid = row - CHUNK            # record row → global triangle id
            better = cover & ((d < acc_d) | ((d == acc_d) & (tid > acc_t)))
            carry = (jnp.where(better, d, acc_d),
                     jnp.where(better, tid, acc_t))
        return carry

    init_d = jnp.full((NPX,), 1.0, jnp.float32)
    if depth_only:
        depth_ref[...] = jax.lax.fori_loop(off_ref[tile], off_ref[tile + 1],
                                           entry, init_d)
        return
    acc_d, acc_t = jax.lax.fori_loop(
        off_ref[tile], off_ref[tile + 1], entry,
        (init_d, jnp.full((NPX,), -1, jnp.int32)))
    depth_ref[...] = acc_d
    tri_ref[0][...] = acc_t


def untile_frame(flat: Array, ntx: int, nty: int) -> Array:
    """(n_tiles, TH·TW) → (H, W)."""
    return (flat.reshape(nty, ntx, TILE_H, TILE_W)
            .transpose(0, 2, 1, 3).reshape(nty * TILE_H, ntx * TILE_W))


def visibility(setup: TriangleSetup, width: int, height: int, *,
               interpret: bool, y_offset=0,
               depth_only: bool = False) -> GBuffer:
    """Tile-binned visibility: per-pixel winner triangle + depth.

    `interpret=True` runs the Triton kernel in the Pallas interpreter (the
    CPU tests). `y_offset` (int or traced i32 scalar, any row) renders a
    horizontal band of `height` rows whose top is that global pixel row:
    setup.bbox must already be band-local (ops.vertex.band_slice_setup)
    while edge/z/w stay global, so band arithmetic is bit-identical to
    the full-frame render. The kernel is an ordinary input of the band
    offset, so under shard_map it is each device's own traced value. `depth_only` (the shadow
    pass) returns tri_id None."""
    ntx = -(-width // TILE_W)
    nty = -(-height // TILE_H)
    n_tiles = ntx * nty
    bins = build_bins(setup, ntx * TILE_W, nty * TILE_H)
    y0 = jnp.asarray(y_offset, jnp.int32).reshape(1)
    out_spec = pl.BlockSpec((None, NPX), lambda t: (t, 0))
    out_shape = [jax.ShapeDtypeStruct((n_tiles, NPX), jnp.float32)]
    if not depth_only:
        out_shape.append(jax.ShapeDtypeStruct((n_tiles, NPX), jnp.int32))
    out = pl.pallas_call(
        lambda *refs: _visibility_kernel(*refs, ntx=ntx),
        grid=(n_tiles,),
        out_specs=[out_spec] * len(out_shape),
        out_shape=out_shape,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="visibility_tiles",
    )(bins.off, bins.ent_row, bins.records, y0)
    depth = untile_frame(out[0], ntx, nty)[:height, :width]
    tri = None if depth_only else untile_frame(out[1], ntx, nty)[:height,
                                                                  :width]
    return GBuffer(tri_id=tri, depth=depth, aux=bins.aux)


def rasterize(setup, width: int, height: int, *, raster: str,
              interpret: bool, chunk: int = 64, y_offset=0,
              depth_only: bool = False):
    """Visibility pass → GBuffer. `raster` "pallas" is the tile-binned
    kernel (`visibility`; `interpret` runs it in the Pallas interpreter),
    "ref" the O(T·pixels) oracle. `y_offset` (int or traced i32) renders
    the band of a taller frame that starts at that global pixel row."""
    if raster == "pallas":
        return visibility(setup, width, height, interpret=interpret,
                          y_offset=y_offset, depth_only=depth_only)
    if raster == "ref":
        from trident.ops.raster_ref import visibility_ref

        g = visibility_ref(setup, width, height, chunk=chunk,
                           y_offset=y_offset)
        return g._replace(aux=jnp.zeros((2,), jnp.int32))   # never drops
    raise ValueError(f"raster={raster!r}: expected 'pallas' or 'ref'")
