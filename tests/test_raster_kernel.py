"""The binned Triton visibility kernel on the CPU, in the Pallas
interpreter: the REAL binning + kernel logic (ops/raster.py) against the
reference oracle (depth semantics: Pipeline.cpp:549-725), plus the
capacity paths the oracle comparison alone cannot show — pair-budget
truncation, whale drops — and the CSR offsets the kernel walks."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from trident.ops import raster
from trident.ops.raster import (
    CHUNK, SUB, TILE_H, TILE_W, build_bins, tile_offsets, visibility)
from trident.ops.raster_ref import visibility_ref
from trident.ops.vertex import band_slice_setup, triangle_setup

W, H = 256, 64    # 8×2 = 16 raster tiles — small enough for the interpreter
WB = 384          # wider than the base span → full-screen bboxes are whales


def _setup_from_ndc(pos, w_coord=None, w=W, h=H):
    """(T,3,3) NDC-ish positions (+ optional (T,3) w) → TriangleSetup."""
    t = pos.shape[0]
    ww = np.ones((t, 3, 1), np.float32) if w_coord is None \
        else np.asarray(w_coord, np.float32)[..., None]
    clip = np.concatenate(
        [pos[..., :2] * ww, (pos[..., 2:3] * 0.5 + 0.5) * ww, ww],
        axis=-1).astype(np.float32)
    tri_vtx = jnp.arange(t * 3, dtype=jnp.int32).reshape(t, 3)
    return triangle_setup(jnp.asarray(clip.reshape(t * 3, 4)), tri_vtx,
                          jnp.ones(t, bool), w, h)


def _random(rng, t=200, spread=0.9, size=0.2, w=W, h=H):
    pos = (rng.uniform(-1, 1, (t, 1, 3)) * [spread, spread, 0.4]
           + rng.uniform(-size, size, (t, 3, 3)))
    ww = np.ones((t, 3), np.float32) * rng.uniform(0.5, 2.0, (t, 1))
    return _setup_from_ndc(pos, ww, w=w, h=h)


def scene_random(rng):
    return _random(rng), W, H


def scene_clustered(rng):
    """Many triangles crammed into one screen corner: several chunks land
    on the same tiles (long per-tile entry lists)."""
    pos = (rng.uniform(-1, -0.6, (640, 1, 3)) * [1, 1, 0]
           + rng.uniform(-0.1, 0.1, (640, 3, 3)) + [0, 0, 0.3])
    return _setup_from_ndc(pos), W, H


def scene_near_plane(rng):
    """Triangles crossing w<=0 get conservative full-screen bboxes."""
    t = 96
    pos = rng.uniform(-0.8, 0.8, (t, 3, 3)).astype(np.float32)
    pos[:, :, 2] = rng.uniform(0.1, 0.9, (t, 3))
    ww = np.ones((t, 3), np.float32)
    ww[:5, 0] = -0.5  # some vertices behind the eye
    return _setup_from_ndc(pos, ww, w=WB), WB, H


def scene_whale(rng):
    """Screen-filling triangles among small ones: their chunks go down
    the whale (every-tile) path."""
    small = rng.uniform(-1, 1, (CHUNK, 1, 3)) * [0.9, 0.9, 0.2] \
        + rng.uniform(-0.05, 0.05, (CHUNK, 3, 3))
    huge = np.array([[[-4.0, -4.0, 0.6], [4.0, -4.0, 0.6], [0.0, 6.0, 0.6]],
                     [[-5.0, 5.0, 0.8], [5.0, 5.0, 0.8], [0.0, -6.0, 0.8]]])
    pos = np.concatenate([small, huge], axis=0).astype(np.float32)
    return _setup_from_ndc(pos, w=WB), WB, H


def scene_empty(rng):
    return _setup_from_ndc(np.zeros((4, 3, 3), np.float32)), W, H


def scene_odd_size(rng):
    """A frame that is not a whole number of tiles in either axis."""
    return _random(rng, t=150, w=200, h=50), 200, 50


def scene_ties(rng):
    """Equal-depth layers: constant-z quads overlap, so winners are
    decided by the later-triangle-wins tie rule."""
    t = 120
    pos = (rng.uniform(-1, 1, (t, 1, 3)) * [0.8, 0.8, 0]
           + rng.uniform(-0.3, 0.3, (t, 3, 3))).astype(np.float32)
    pos[:, :, 2] = np.where(np.arange(t)[:, None] % 2, 0.25, -0.25)
    return _setup_from_ndc(pos), W, H


def scene_multi_chunk(rng):
    """Several chunks per tile with interleaved depths (the per-tile loop
    crosses chunk boundaries)."""
    return _random(rng, t=CHUNK * 3 + 17, size=0.08), W, H


def scene_tall(rng):
    """More tile rows than columns."""
    return _random(rng, t=120, w=64, h=160), 64, 160


SCENES = {f.__name__[6:]: f for f in (
    scene_random, scene_clustered, scene_near_plane, scene_whale,
    scene_empty, scene_odd_size, scene_ties, scene_multi_chunk, scene_tall)}


def _kernel(setup, w, h, **kw):
    """Jitted interpret-mode kernel: eager interpret dispatches op by op;
    the jitted graph compiles in seconds."""
    return jax.jit(lambda s: visibility(s, w, h, interpret=True, **kw))(setup)


def _ref(setup, w, h, y_offset=0):
    return jax.jit(lambda s: visibility_ref(s, w, h, y_offset=y_offset))(
        setup)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_kernel_matches_oracle(name):
    setup, w, h = SCENES[name](np.random.default_rng(1234))
    ref = _ref(setup, w, h)
    got = _kernel(setup, w, h)
    assert got.tri_id.shape == (h, w) and got.depth.shape == (h, w)
    np.testing.assert_array_equal(np.asarray(ref.tri_id),
                                  np.asarray(got.tri_id))
    np.testing.assert_allclose(np.asarray(ref.depth), np.asarray(got.depth),
                               atol=1e-6)
    assert np.asarray(got.aux).tolist() == [0, 0]


@pytest.mark.parametrize("name", sorted(SCENES))
def test_depth_only_pass_is_the_depth_plane(name):
    """The shadow pass's depth-only kernel (plain min merge) gives the
    full kernel's depth plane bit for bit."""
    setup, w, h = SCENES[name](np.random.default_rng(99))
    full = _kernel(setup, w, h)
    depth = _kernel(setup, w, h, depth_only=True)
    assert depth.tri_id is None
    np.testing.assert_array_equal(np.asarray(full.depth),
                                  np.asarray(depth.depth))


@pytest.mark.parametrize("band", [0, 1, 3])
def test_band_offset_matches_full_frame(band):
    """A band that starts on a tile row (the multi-chip path) is the same
    rows of the full-frame render, bit for bit."""
    w, h, band_h = 128, 128, 32
    setup = _random(np.random.default_rng(7), t=300, w=w, h=h)
    full = _kernel(setup, w, h)
    y0 = band * band_h
    part = jax.jit(lambda s: visibility(
        band_slice_setup(s, y0, band_h), w, band_h, interpret=True,
        y_offset=y0))(setup)
    ref = _ref(band_slice_setup(setup, y0, band_h), w, band_h, y_offset=y0)
    np.testing.assert_array_equal(np.asarray(part.tri_id),
                                  np.asarray(full.tri_id)[y0:y0 + band_h])
    np.testing.assert_array_equal(np.asarray(part.depth),
                                  np.asarray(full.depth)[y0:y0 + band_h])
    np.testing.assert_array_equal(np.asarray(part.tri_id),
                                  np.asarray(ref.tri_id))


@pytest.mark.parametrize("y0,band_h", [(40, 40), (20, 36), (100, 28)])
def test_band_of_any_height_matches_full_frame(y0, band_h):
    """Bands need not be whole tile rows (4K in 4 bands is 540 rows
    each): the kernel pads the band to whole tiles, offsets by pixel
    rows, and still reproduces the full frame's rows bit for bit."""
    w, h = 128, 128
    setup = _random(np.random.default_rng(7), t=300, w=w, h=h)
    full = _kernel(setup, w, h)
    part = jax.jit(lambda s: visibility(
        band_slice_setup(s, y0, band_h), w, band_h, interpret=True,
        y_offset=y0))(setup)
    assert part.tri_id.shape == (band_h, w)
    np.testing.assert_array_equal(np.asarray(part.tri_id),
                                  np.asarray(full.tri_id)[y0:y0 + band_h])
    np.testing.assert_array_equal(np.asarray(part.depth),
                                  np.asarray(full.depth)[y0:y0 + band_h])


@pytest.mark.parametrize("tiles,n_tiles,want", [
    ([], 3, [0, 0, 0, 0]),
    ([0, 0, 2], 3, [0, 2, 2, 3]),
    ([1, 1, 1, 3], 4, [0, 0, 3, 3, 4]),
    ([2, 2], 3, [0, 0, 0, 2]),
])
def test_tile_offsets_csr(tiles, n_tiles, want):
    """CSR offsets over a tile-sorted entry list with n_tiles padding:
    tile t owns [off[t], off[t+1]); off[n_tiles] is the real count."""
    ent = jnp.asarray(tiles + [n_tiles] * 5, jnp.int32)
    np.testing.assert_array_equal(np.asarray(tile_offsets(ent, n_tiles)),
                                  want)


@pytest.mark.parametrize("name", ["random", "clustered", "whale"])
def test_entries_cover_every_covering_triangle(name):
    """Every (tile, triangle) the oracle sees covering a pixel appears in
    the tile's CSR range as the triangle's sub-block, and the entry list
    is tile-sorted with a real-count prefix."""
    setup, w, h = SCENES[name](np.random.default_rng(5))
    ntx, nty = -(-w // TILE_W), -(-h // TILE_H)
    bins = jax.jit(lambda s: build_bins(s, ntx * TILE_W, nty * TILE_H))(
        setup)
    off = np.asarray(bins.off)
    rows = np.asarray(bins.ent_row)
    tiles = np.asarray(bins.ent_tile)
    n = int(bins.n_ent)
    assert off[-1] == n and (np.diff(tiles[:n]) >= 0).all()
    assert (tiles[n:] == ntx * nty).all()
    ref = np.asarray(_ref(setup, w, h).tri_id)
    for y, x in zip(*np.nonzero(ref >= 0)):
        t = (y // TILE_H) * ntx + x // TILE_W
        sub_row = (ref[y, x] // SUB) * SUB + CHUNK   # record row of its sub
        assert sub_row in rows[off[t]:off[t + 1]], (y, x, ref[y, x])


def test_pair_budget_truncation_is_clean(monkeypatch):
    """With PAIR_BUDGET below the real pair count, overflow drops whole
    (tile, chunk) pairs: every pixel is the untruncated result,
    background, or FARTHER real geometry — never nearer, never an id out
    of range — and aux[0] counts the dropped pairs."""
    setup = _random(np.random.default_rng(3), t=256, spread=0.95, size=0.3)
    full = _kernel(setup, W, H)
    monkeypatch.setattr(raster, "PAIR_BUDGET", 6)
    got = _kernel(setup, W, H)
    aux = np.asarray(got.aux)
    assert aux[0] > 0 and aux[1] == 0
    pt, ft = np.asarray(got.tri_id), np.asarray(full.tri_id)
    pd, fd = np.asarray(got.depth), np.asarray(full.depth)
    match = (pt == ft) & (pd == fd)
    background = (pt == -1) & (pd == 1.0)
    farther = (pd >= fd) & (pt >= -1) & (pt < setup.edge.shape[0])
    assert (match | background | farther).all()
    assert (~match).any() and match.any()     # truncation actually bit


def test_whale_drop_is_counted_not_garbage(monkeypatch):
    """With the mid tiers closed and MAX_GLOBAL shrunk, excess whale
    chunks drop: aux[1] counts them, and every pixel is background or a
    triangle of a KEPT chunk."""
    monkeypatch.setattr(raster, "MID_CAPS", (0, 0))
    monkeypatch.setattr(raster, "MAX_GLOBAL", 2)
    rng = np.random.default_rng(8)
    t = CHUNK * 5                          # 5 chunks, all near-plane → whales
    pos = rng.uniform(-0.8, 0.8, (t, 3, 3)).astype(np.float32)
    pos[:, :, 2] = rng.uniform(0.1, 0.9, (t, 3))
    ww = np.ones((t, 3), np.float32)
    ww[::CHUNK, 0] = -0.5
    setup = _setup_from_ndc(pos, ww, w=WB)
    got = _kernel(setup, WB, H)
    assert np.asarray(got.aux).tolist() == [0, 3]
    pt = np.asarray(got.tri_id)
    assert (np.isin(pt // CHUNK, [0, 1]) | (pt == -1)).all()


def test_4k_scale_chunk_spans_bin_without_drops():
    """At 3840×2160 the ~2×2-tile chunks of the 1080p calibration become
    ~4×4; the base span scales with the frame's tile extent so a dense
    4K scene bins with ZERO drops. Binning only — no kernel run."""
    w4k, h4k = 3840, 2160
    n_chunks = 512
    t = n_chunks * CHUNK
    rng = np.random.default_rng(7)
    cx = rng.uniform(0, w4k - 4 * TILE_W, n_chunks)
    cy = rng.uniform(0, h4k - 4 * TILE_H, n_chunks)
    ox = rng.uniform(0, 4 * TILE_W - 8, (n_chunks, CHUNK, 1))
    oy = rng.uniform(0, 4 * TILE_H - 8, (n_chunks, CHUNK, 1))
    px = cx[:, None, None] + ox + rng.uniform(4, 24, (n_chunks, CHUNK, 3))
    py = cy[:, None, None] + oy + rng.uniform(4, 24, (n_chunks, CHUNK, 3))
    nx = (px.reshape(t, 3) / w4k) * 2 - 1
    ny = (py.reshape(t, 3) / h4k) * 2 - 1
    pos = np.stack([nx, ny, np.full_like(nx, 0.3)], axis=-1).astype(
        np.float32)
    setup = _setup_from_ndc(pos, w=w4k, h=h4k)
    bins = jax.jit(lambda s: build_bins(
        s, w4k, -(-h4k // TILE_H) * TILE_H))(setup)
    assert np.asarray(bins.aux).tolist() == [0, 0]
    assert int(bins.n_ent) > 0


def test_sentinel_and_padding_records_never_cover():
    """Record chunk slot 0 and the tail padding rows are empty triangles
    (e ≡ -1): a kernel reading them by mistake would paint nothing."""
    setup = _random(np.random.default_rng(2), t=CHUNK + 5)
    rec = np.asarray(jax.jit(lambda s: build_bins(s, W, H).records)(setup))
    assert rec.shape == ((2 + 1) * CHUNK, raster.REC_W)
    for rows in (rec[:CHUNK], rec[2 * CHUNK + 5:]):
        np.testing.assert_array_equal(rows[:, [0, 1, 3, 4, 6, 7]], 0.0)
        np.testing.assert_array_equal(rows[:, [2, 5, 8]], -1.0)


def test_rasterize_dispatch():
    """rasterize() routes "pallas" to the kernel and "ref" to the oracle
    (whose drop counters are zero), and refuses anything else."""
    setup = _random(np.random.default_rng(4), t=60)
    a = jax.jit(lambda s: raster.rasterize(s, W, H, raster="pallas",
                                           interpret=True))(setup)
    b = jax.jit(lambda s: raster.rasterize(s, W, H, raster="ref",
                                           interpret=True))(setup)
    np.testing.assert_array_equal(np.asarray(a.tri_id), np.asarray(b.tri_id))
    assert np.asarray(b.aux).tolist() == [0, 0]
    with pytest.raises(ValueError):
        raster.rasterize(setup, W, H, raster="hardware", interpret=True)
