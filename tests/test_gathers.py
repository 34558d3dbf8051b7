"""The per-pixel gathers that shading does in plain XLA — texel fetch,
shadow-map taps (hard and PCF) and the upscaler's history warp — against
straightforward numpy loops."""

import numpy as np
import pytest

import jax.numpy as jnp

from trident.ops import shading
from trident.ops.shadow import shadow_factor
from trident.render.textures import TextureSlots
from trident.render.types import ShadowParams


def _shadow_np(depth, world, bias, pcf):
    """Reference: identity light_vp, so ndc = world."""
    s = depth.shape[0]
    out = np.ones(world.shape[:-1], np.float32)
    for idx in np.ndindex(*world.shape[:-1]):
        x, y, z = (float(v) for v in world[idx])
        u, v = (x + 1.0) * 0.5, (y + 1.0) * 0.5
        if not (0 <= u <= 1 and 0 <= v <= 1 and z <= 1.0):
            continue
        t = z - bias

        def lit(yi, xi):
            yi, xi = min(max(yi, 0), s - 1), min(max(xi, 0), s - 1)
            return 0.0 if t > depth[yi, xi] else 1.0

        if not pcf:
            out[idx] = lit(int(v * s), int(u * s))
            continue
        fx, fy = u * s - 0.5, v * s - 0.5
        x0, y0 = int(np.floor(fx)), int(np.floor(fy))
        wx, wy = fx - x0, fy - y0
        out[idx] = ((lit(y0, x0) * (1 - wx) + lit(y0, x0 + 1) * wx)
                    * (1 - wy)
                    + (lit(y0 + 1, x0) * (1 - wx) + lit(y0 + 1, x0 + 1) * wx)
                    * wy)
    return out


@pytest.mark.parametrize("pcf", [False, True])
def test_shadow_taps_match_numpy(pcf):
    rng = np.random.default_rng(3)
    s = 16
    depth = rng.uniform(0.2, 0.9, (s, s)).astype(np.float32)
    world = np.concatenate([rng.uniform(-1.2, 1.2, (12, 10, 2)),
                            rng.uniform(0.0, 1.0, (12, 10, 1))],
                           axis=-1).astype(np.float32)
    params = ShadowParams(depth=jnp.asarray(depth),
                          light_vp=jnp.eye(4, dtype=jnp.float32),
                          enabled=jnp.asarray(True),
                          bias=jnp.asarray(0.01, jnp.float32))
    got = np.asarray(shadow_factor(params, jnp.asarray(world), pcf=pcf))
    np.testing.assert_allclose(got[..., 0],
                               _shadow_np(depth, world, 0.01, pcf),
                               atol=1e-5)


def _texture(edge_w, edge_h, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (edge_h, edge_w, 4), dtype=np.uint8)
    store = TextureSlots()
    slot = store.acquire("noise", img)
    return store.device_arrays(), slot, img.astype(np.float32) / 255.0


@pytest.mark.parametrize("w,h", [(16, 16), (32, 8)])
def test_bilinear_texel_fetch_matches_numpy(w, h):
    """Level-0 bilinear sampling with REPEAT wrap, from the quad table,
    equals a direct lerp of the source image."""
    tex, slot, img = _texture(w, h, seed=w + h)
    rng = np.random.default_rng(11)
    uv = rng.uniform(-1.5, 2.5, (9, 7, 2)).astype(np.float32)
    got = np.asarray(shading.sample_texture(
        tex, jnp.full((9, 7), slot, jnp.int32), jnp.asarray(uv),
        jnp.zeros((9, 7), jnp.float32), mode="bilinear"))
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]

    def at(yy, xx):
        return img[yy % h, xx % w]

    want = ((at(y0, x0) * (1 - fx) + at(y0, x0 + 1) * fx) * (1 - fy)
            + (at(y0 + 1, x0) * (1 - fx) + at(y0 + 1, x0 + 1) * fx) * fy)
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_nearest_texel_fetch_matches_numpy():
    tex, slot, img = _texture(16, 16, seed=5)
    rng = np.random.default_rng(12)
    uv = rng.uniform(0.01, 0.99, (6, 5, 2)).astype(np.float32)
    got = np.asarray(shading.sample_texture(
        tex, jnp.full((6, 5), slot, jnp.int32), jnp.asarray(uv),
        jnp.zeros((6, 5), jnp.float32), mode="nearest"))
    want = img[np.floor(uv[..., 1] * 16).astype(int) % 16,
               np.floor(uv[..., 0] * 16).astype(int) % 16]
    np.testing.assert_allclose(got, want, atol=1e-6)


def _warp_inputs(rng, h=6, w=8):
    blocks = rng.integers(0, 256, (h, w, 12), dtype=np.uint8)
    depth = rng.uniform(0.1, 1.0, (h, w)).astype(np.float32)
    depth[0, 0] = 1.0                                  # background
    # a small screen-space shift: prev_vp = translate(x) ∘ cur_vp
    shift = np.eye(4, dtype=np.float32)
    shift[0, 3] = 0.3
    return blocks, depth, np.eye(4, dtype=np.float32), shift


def test_warp_from_blocks_matches_numpy():
    """The V2 history warp: reproject each half-res pixel, gather the
    2×2 output block under it (or zero it with validity 0)."""
    from trident.ai.upscaler import warp_from_blocks

    rng = np.random.default_rng(21)
    blocks, depth, vp_inv, prev_vp = _warp_inputs(rng)
    h, w = depth.shape
    got = np.asarray(warp_from_blocks(
        jnp.asarray(blocks), jnp.asarray(depth), jnp.asarray(vp_inv),
        jnp.asarray(prev_vp), 2 * w, 2 * h))
    for y in range(h):
        for x in range(w):
            ndc = np.array([(x + 0.5) * 2 / w - 1, (y + 0.5) * 2 / h - 1,
                            depth[y, x], 1.0])
            clip = prev_vp @ (vp_inv @ ndc)
            px = (clip[0] / clip[3] + 1) * 0.5 * 2 * w
            py = (clip[1] / clip[3] + 1) * 0.5 * 2 * h
            bx, by = int(np.round(px * 0.5 - 0.5)), int(np.round(py * 0.5
                                                                 - 0.5))
            ok = (0 <= bx < w and 0 <= by < h and clip[3] > 1e-6
                  and depth[y, x] < 1.0)
            want = (blocks[by, bx].astype(np.float32) / 255.0 if ok
                    else np.zeros(12, np.float32))
            np.testing.assert_allclose(got[y, x, :12], want, atol=1e-6)
            assert got[y, x, 12] == float(ok)
