"""The reference oracle (ops/raster_ref.py) and its helpers: the pixel-
bbox clip both rasterizers apply, band slicing, and the mismatch
classifier the on-card parity tests rely on."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from trident.ops.raster import TILE_H, TILE_W, untile_frame, visibility
from trident.ops.raster_ref import unexplained_mismatches, visibility_ref
from trident.ops.vertex import band_slice_setup, triangle_setup


def _setup(clip, w, h):
    t = clip.shape[0]
    tri_vtx = jnp.arange(t * 3, dtype=jnp.int32).reshape(t, 3)
    return triangle_setup(jnp.asarray(clip.reshape(t * 3, 4)), tri_vtx,
                          jnp.ones(t, bool), w, h)


def _clip(pos, ww):
    return np.concatenate(
        [pos[..., :2] * ww, (pos[..., 2:3] * 0.5 + 0.5) * ww, ww],
        axis=-1).astype(np.float32)


def _sliver():
    """Triangle 78980 of the 110k clustered 1080p scene (tests/test_gpu.py):
    a sliver whose three edge functions all stay positive along a line
    that runs ~100 px outside its 3×3-pixel bbox."""
    rng = np.random.default_rng(11)
    k, ncl, g = 256, 430, 21
    t = ncl * k
    cy, cx = np.divmod(np.arange(ncl), g)
    centers = np.stack([(cx + 0.5) / g * 1.9 - 0.95,
                        (cy + 0.5) / g * 1.9 - 0.95], axis=-1)
    pos = np.concatenate([
        (centers[:, None, :] + rng.uniform(-0.03, 0.03, (ncl, k, 2))
         ).reshape(t, 1, 2),
        rng.uniform(-0.4, 0.4, (t, 1, 1)),
    ], axis=-1) + rng.uniform(-0.004, 0.004, (t, 3, 3))
    ww = np.ones((t, 3, 1), np.float32) * rng.uniform(0.5, 2.0, (t, 1, 1))
    return _setup(_clip(pos[78980:78981], ww[78980:78981]), 1920, 1080)


def test_sliver_edges_are_positive_outside_its_bbox():
    """The premise of the bbox clip: at pixel (664, 1198), far outside the
    sliver's bbox, all three of its edge functions are positive."""
    s = _sliver()
    x0, y0, x1, y1 = np.asarray(s.bbox)[0]
    assert not (x0 <= 1198 < x1 and y0 <= 664 < y1)
    e = np.asarray(s.edge, np.float64)[0] @ np.array([1198.5, 664.5, 1.0])
    assert (e > 0).all()


def test_oracle_clips_sliver_to_bbox():
    """The oracle paints the sliver only inside its pixel bbox (unclipped,
    its edge functions cover four pixels on rows 664-703; clipped, it
    covers no pixel center at all)."""
    s = _sliver()
    ref = jax.jit(lambda b: visibility_ref(b, 1920, 1080, chunk=1))(s)
    x0, y0, x1, y1 = np.asarray(s.bbox)[0]
    rows, cols = np.nonzero(np.asarray(ref.tri_id) >= 0)
    assert ((cols >= x0) & (cols < x1) & (rows >= y0) & (rows < y1)).all()


def test_kernel_matches_oracle_on_sliver_band():
    """In the band that holds the sliver's bbox, the kernel paints what
    the oracle paints."""
    s = _sliver()
    y0, band_h = 704, 64
    bs = band_slice_setup(s, y0, band_h)
    ref = jax.jit(lambda b: visibility_ref(b, 1920, band_h, chunk=1,
                                           y_offset=y0))(bs)
    got = jax.jit(lambda b: visibility(b, 1920, band_h, interpret=True,
                                       y_offset=y0))(bs)
    np.testing.assert_array_equal(np.asarray(ref.tri_id),
                                  np.asarray(got.tri_id))


@pytest.mark.parametrize("y0,band_h", [(0, 32), (40, 24), (100, 64)])
def test_band_slice_setup_shifts_and_culls(y0, band_h):
    """Bboxes move to band-local rows clipped to [0, band_h]; triangles
    that miss the band go invalid; edge/z/w stay global."""
    rng = np.random.default_rng(3)
    t = 64
    pos = rng.uniform(-1, 1, (t, 1, 3)) * [0.9, 0.9, 0.4] \
        + rng.uniform(-0.1, 0.1, (t, 3, 3))
    s = _setup(_clip(pos, np.ones((t, 3, 1))), 128, 160)
    b = band_slice_setup(s, y0, band_h)
    full, band = np.asarray(s.bbox), np.asarray(b.bbox)
    np.testing.assert_array_equal(band[:, [0, 2]], full[:, [0, 2]])
    np.testing.assert_array_equal(band[:, 1],
                                  np.clip(full[:, 1] - y0, 0, band_h))
    np.testing.assert_array_equal(band[:, 3],
                                  np.clip(full[:, 3] - y0, 0, band_h))
    misses = (full[:, 3] <= y0) | (full[:, 1] >= y0 + band_h)
    assert not np.asarray(b.valid)[misses].any()
    np.testing.assert_array_equal(np.asarray(b.edge), np.asarray(s.edge))


@pytest.mark.parametrize("y0", [0, 48])
def test_oracle_band_is_rows_of_full_frame(y0):
    """visibility_ref on a band slice with its y_offset equals those rows
    of the whole-frame oracle, bit for bit."""
    rng = np.random.default_rng(8)
    t = 150
    pos = rng.uniform(-1, 1, (t, 1, 3)) * [0.9, 0.9, 0.4] \
        + rng.uniform(-0.2, 0.2, (t, 3, 3))
    ww = np.ones((t, 3, 1)) * rng.uniform(0.5, 2.0, (t, 1, 1))
    w, h, band_h = 96, 96, 48
    s = _setup(_clip(pos, ww), w, h)
    full = jax.jit(lambda x: visibility_ref(x, w, h))(s)
    part = jax.jit(lambda x: visibility_ref(
        band_slice_setup(x, y0, band_h), w, band_h, y_offset=y0))(s)
    np.testing.assert_array_equal(np.asarray(part.tri_id),
                                  np.asarray(full.tri_id)[y0:y0 + band_h])
    np.testing.assert_array_equal(np.asarray(part.depth),
                                  np.asarray(full.depth)[y0:y0 + band_h])


def test_untile_frame_inverts_tiling():
    ntx, nty = 3, 2
    frame = np.arange(nty * TILE_H * ntx * TILE_W).reshape(nty * TILE_H,
                                                           ntx * TILE_W)
    tiles = (frame.reshape(nty, TILE_H, ntx, TILE_W).transpose(0, 2, 1, 3)
             .reshape(ntx * nty, TILE_H * TILE_W))
    np.testing.assert_array_equal(
        np.asarray(untile_frame(jnp.asarray(tiles), ntx, nty)), frame)


def _one_triangle():
    """A front-facing triangle in a 16×16 frame with pixel-exact corners
    (0.5, 0.5), (12.5, 12.5), (0.5, 12.5): its hypotenuse x = y runs
    through pixel centers, where that edge function is exactly 0."""
    ndc = lambda p: p / 8.0 - 1.0
    pos = np.array([[[ndc(0.5), ndc(0.5), 0.0], [ndc(12.5), ndc(12.5), 0.0],
                     [ndc(0.5), ndc(12.5), 0.0]]])
    s = _setup(_clip(pos, np.ones((1, 3, 1))), 16, 16)
    if not bool(np.asarray(s.valid)[0]):   # wound the other way round
        s = _setup(_clip(pos[:, ::-1], np.ones((1, 3, 1))), 16, 16)
    return s


@pytest.mark.parametrize("case,pixel,explained", [
    ("tie", (10, 3), True), ("boundary", (6, 6), True),
    ("far_miss", (10, 3), False)])
def test_unexplained_mismatches_classifies(case, pixel, explained):
    """A depth tie and a flip on an edge through the pixel center are
    benign; a pixel deep inside the triangle that the kernel left empty
    is not."""
    s = _one_triangle()
    ref = visibility_ref(s, 16, 16)
    rt, rd = np.asarray(ref.tri_id), np.asarray(ref.depth)
    y, x = pixel
    assert rt[y, x] == 0
    pt, pd = rt.copy(), rd.copy()
    if case == "tie":
        pt[y, x] = 7                 # another triangle at the same depth
    else:
        pt[y, x], pd[y, x] = -1, 1.0
    bad = unexplained_mismatches(s, rt, rd, pt, pd)
    assert (bad == []) == explained, bad
