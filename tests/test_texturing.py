"""Texture sampling modes, mip selection, Morton ordering properties."""

import numpy as np
import pytest

import jax.numpy as jnp

from trident.geometry.mesh import morton_order
from trident.ops.shading import sample_texture
from trident.render.textures import TextureSlots


def make_tex(edge=64):
    slots = TextureSlots(max_slots=8, edge=edge)
    # red/blue vertical split texture
    img = np.zeros((edge, edge, 4), np.uint8)
    img[:, : edge // 2] = [255, 0, 0, 255]
    img[:, edge // 2:] = [0, 0, 255, 255]
    slot = slots.acquire("split", img)
    return slots.device_arrays(), slot


def test_nearest_vs_bilinear_at_mip0():
    tex, slot = make_tex()
    uv = jnp.asarray([[0.25, 0.5], [0.75, 0.5]], jnp.float32)
    slots = jnp.full(2, slot, jnp.int32)
    mip = jnp.zeros(2, jnp.float32)
    for mode in ("nearest", "bilinear", "trilinear"):
        out = np.asarray(sample_texture(tex, slots, uv, mip, mode=mode))
        assert out[0, 0] > 0.9 and out[0, 2] < 0.1   # left = red
        assert out[1, 2] > 0.9 and out[1, 0] < 0.1   # right = blue


def test_bilinear_blends_at_boundary():
    tex, slot = make_tex()
    # exactly on the red/blue seam: bilinear mixes, nearest snaps
    uv = jnp.asarray([[0.5, 0.5]], jnp.float32)
    slots = jnp.full(1, slot, jnp.int32)
    mip = jnp.zeros(1, jnp.float32)
    bil = np.asarray(sample_texture(tex, slots, uv, mip, mode="bilinear"))[0]
    assert 0.2 < bil[0] < 0.8 and 0.2 < bil[2] < 0.8
    near = np.asarray(sample_texture(tex, slots, uv, mip, mode="nearest"))[0]
    assert near[0] > 0.9 or near[2] > 0.9


def test_high_mip_averages():
    tex, slot = make_tex()
    uv = jnp.asarray([[0.25, 0.5]], jnp.float32)
    slots = jnp.full(1, slot, jnp.int32)
    # the top mip is the average of red and blue → purple-ish
    top = float(np.log2(64))
    out = np.asarray(sample_texture(tex, slots, uv,
                                    jnp.full(1, top, jnp.float32),
                                    mode="bilinear"))[0]
    assert 0.2 < out[0] < 0.8 and 0.2 < out[2] < 0.8


def test_repeat_wrap():
    tex, slot = make_tex()
    slots = jnp.full(1, slot, jnp.int32)
    mip = jnp.zeros(1, jnp.float32)
    a = np.asarray(sample_texture(tex, slots, jnp.asarray([[0.25, 0.5]]), mip))
    b = np.asarray(sample_texture(tex, slots, jnp.asarray([[1.25, 0.5]]), mip))
    c = np.asarray(sample_texture(tex, slots, jnp.asarray([[-0.75, 0.5]]), mip))
    np.testing.assert_allclose(a, b, atol=1e-5)
    np.testing.assert_allclose(a, c, atol=1e-5)


def test_morton_order_locality(rng):
    """Consecutive triangles after Morton sort are spatially closer than in
    a scrambled order (what the raster binner's chunk bboxes depend on)."""
    n = 4096
    centers = rng.random((n, 3)).astype(np.float32)
    tri = np.arange(n * 3, dtype=np.int32)
    positions = np.repeat(centers, 3, axis=0) \
        + rng.normal(0, 1e-3, (n * 3, 3)).astype(np.float32)
    scrambled = tri.reshape(-1, 3)[rng.permutation(n)].reshape(-1)
    sorted_idx = morton_order(scrambled, positions)

    def chunk_extent(indices, chunk=64):
        t = indices.reshape(-1, 3)
        cent = positions[t].mean(axis=1)
        nc = len(cent) // chunk
        cent = cent[: nc * chunk].reshape(nc, chunk, 3)
        return (cent.max(axis=1) - cent.min(axis=1)).mean()

    assert chunk_extent(sorted_idx) < chunk_extent(scrambled) * 0.5
    # same multiset of triangles
    assert sorted({tuple(sorted(t)) for t in sorted_idx.reshape(-1, 3)}) == \
        sorted({tuple(sorted(t)) for t in scrambled.reshape(-1, 3)})


def test_plane_f16_quality():
    """f16 plane tables (anchored + rescaled) must be visually identical to
    f32: sub-LSB on most pixels, no structural drift."""
    import sys
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from test_golden import build_golden_scene

    r32 = build_golden_scene()
    r32.config.render.plane_f16 = False
    img32 = r32.read_frame().astype(np.float32)
    r16 = build_golden_scene()
    r16.config.render.plane_f16 = True
    img16 = r16.read_frame().astype(np.float32)
    diff = np.abs(img16 - img32)
    assert float(diff.mean()) < 0.6
    assert (diff > 8).mean() < 0.003, f"{int((diff > 8).sum())} px drifted"
    mse = float(np.square(diff / 255.0).mean())
    psnr = 10 * np.log10(1.0 / max(mse, 1e-12))
    assert psnr > 35.0, f"PSNR {psnr:.1f} dB"


def test_native_resolution_1024():
    """A 1024² texture binds unscaled (reference: TextureLoader.cpp:293
    native-size images) and nearest sampling returns its exact texels."""
    slots = TextureSlots(max_slots=8, edge=1024)
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (1024, 1024, 4), dtype=np.uint8)
    img[..., 3] = 255
    slot = slots.acquire("big", img)
    tex = slots.device_arrays()
    assert tuple(np.asarray(tex.sizes[slot, :2])) == (1024, 1024)
    # texel centers: uv = (x+0.5)/1024
    xs = np.array([0, 1, 511, 1023])
    ys = np.array([0, 640, 1023])
    uv = jnp.asarray([[(x + 0.5) / 1024, (y + 0.5) / 1024]
                      for y in ys for x in xs], jnp.float32)
    sl = jnp.full(uv.shape[0], slot, jnp.int32)
    out = np.asarray(sample_texture(tex, sl, uv, jnp.zeros(uv.shape[0]),
                                    mode="nearest"))
    expect = np.stack([img[y, x] for y in ys for x in xs]) / 255.0
    np.testing.assert_allclose(out, expect, atol=1e-6)


def test_memory_proportional_to_texels():
    """Per-slot pyramids: small/empty slots no longer pay the full-edge
    pyramid (round-1 stored ~0.7MB per slot INCLUDING 1×1 white)."""
    small = TextureSlots(max_slots=256, edge=1024)
    small.acquire("a", np.full((32, 32, 4), 128, np.uint8))
    n_small = int(np.asarray(small.device_arrays().quads).shape[0])
    # 8 bucketed slots: one 32² pyramid + seven 1×1 + alignment ≈ a few KB
    assert n_small < 16 * 1024, n_small
    big = TextureSlots(max_slots=256, edge=1024)
    big.acquire("b", np.full((1024, 512, 4), 128, np.uint8))
    n_big = int(np.asarray(big.device_arrays().quads).shape[0])
    assert n_big > 1024 * 1024          # the real pyramid
    assert n_big < 2 * 1400 * 1024      # ~4/3·E² + padding, nothing more


def test_non_pow2_non_square_sampling():
    slots = TextureSlots(max_slots=8, edge=256)
    img = np.zeros((20, 48, 4), np.uint8)          # h=20, w=48
    img[:, :24] = [255, 0, 0, 255]
    img[:, 24:] = [0, 0, 255, 255]
    slot = slots.acquire("odd", img)
    tex = slots.device_arrays()
    assert tuple(np.asarray(tex.sizes[slot])) == (48, 20, *np.asarray(tex.sizes[slot, 2:]))
    uv = jnp.asarray([[0.25, 0.5], [0.75, 0.5], [1.25, 0.5]], jnp.float32)
    sl = jnp.full(3, slot, jnp.int32)
    out = np.asarray(sample_texture(tex, sl, uv, jnp.zeros(3), mode="bilinear"))
    assert out[0, 0] > 0.9 and out[0, 2] < 0.1     # left red
    assert out[1, 2] > 0.9 and out[1, 0] < 0.1     # right blue
    np.testing.assert_allclose(out[2], out[0], atol=1e-5)  # REPEAT wrap


def test_small_slot_minified_past_own_pyramid():
    """Regression (round-3 advisor): a slot smaller than the largest one,
    sampled at a mip past its OWN pyramid depth, must clamp to its 1×1
    tail — not walk into alignment padding or the next slot's texels."""
    slots = TextureSlots(max_slots=8, edge=1024)
    small = np.full((8, 8, 4), 0, np.uint8)
    small[..., 1] = 200                      # green 8×8 → tail level 3
    s_small = slots.acquire("small", small)
    big = np.full((1024, 1024, 4), 0, np.uint8)
    big[..., 0] = 255                        # red 1024² → max_level 10
    slots.acquire("big", big)
    tex = slots.device_arrays()
    assert int(np.asarray(tex.max_level)) == 10

    uv = jnp.asarray([[0.5, 0.5]], jnp.float32)
    sl = jnp.full(1, s_small, jnp.int32)
    tail = np.asarray(sample_texture(
        tex, sl, uv, jnp.full(1, 3.0), mode="bilinear"))[0]
    for lvl in (4.0, 7.0, 10.0):
        out = np.asarray(sample_texture(
            tex, sl, uv, jnp.full(1, lvl), mode="bilinear"))[0]
        np.testing.assert_allclose(out, tail, atol=1e-5, err_msg=f"mip {lvl}")
        assert out[1] > 0.5 and out[0] < 0.1  # still the green slot
