"""GPU tests: the compiled Triton visibility kernel and the production
frame against the reference oracle and the CPU goldens, on the card.

Marked `gpu`: skipped where JAX finds no GPU (the `gpu_device` fixture
decides at run time). Run on the card with

    python -m pytest tests/test_gpu.py -m gpu -p no:cacheprovider
"""

import os
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup(clip, w, h):
    import jax.numpy as jnp

    from trident.ops.vertex import triangle_setup

    t = clip.shape[0]
    tri_vtx = jnp.arange(t * 3, dtype=jnp.int32).reshape(t, 3)
    return triangle_setup(jnp.asarray(clip.reshape(t * 3, 4)), tri_vtx,
                          jnp.ones(t, bool), w, h)


def _clip(pos, ww):
    return np.concatenate(
        [pos[..., :2] * ww, (pos[..., 2:3] * 0.5 + 0.5) * ww, ww],
        axis=-1).astype(np.float32)


def _oracle_in_bands(setup, w, h, band_h):
    """The oracle band by band, each forced before the next: the whole-
    frame scan would build (chunk, 3, H, W) intermediates of ~1.6 GB."""
    from trident.ops.raster_ref import visibility_ref
    from trident.ops.vertex import band_slice_setup

    rt, rd = [], []
    for y0 in range(0, h, band_h):
        band = visibility_ref(band_slice_setup(setup, y0, band_h), w, band_h,
                              chunk=32, y_offset=y0)
        rt.append(np.asarray(band.tri_id))
        rd.append(np.asarray(band.depth))
    return np.concatenate(rt, axis=0), np.concatenate(rd, axis=0)


def test_kernel_matches_oracle_on_gpu(gpu_device):
    """300 random triangles at 256²: identical winners, depth within
    1e-6."""
    import jax

    from trident.ops.raster import visibility
    from trident.ops.raster_ref import visibility_ref

    w = h = 256
    rng = np.random.default_rng(7)
    t = 300
    pos = (rng.uniform(-1, 1, (t, 1, 3)) * [0.9, 0.9, 0.4]
           + rng.uniform(-0.15, 0.15, (t, 3, 3)))
    ww = np.ones((t, 3, 1), np.float32) * rng.uniform(0.5, 2.0, (t, 1, 1))
    setup = _setup(_clip(pos, ww), w, h)
    ref = jax.jit(lambda s: visibility_ref(s, w, h))(setup)
    got = jax.jit(lambda s: visibility(s, w, h, interpret=False))(setup)
    assert got.tri_id.devices() == {gpu_device}
    rt, pt = np.asarray(ref.tri_id), np.asarray(got.tri_id)
    assert (rt != pt).sum() == 0
    np.testing.assert_allclose(np.asarray(ref.depth), np.asarray(got.depth),
                               atol=1e-6)


def test_bench_scale_oracle_parity_on_gpu(gpu_device):
    """110k clustered triangles at 1080p. The cloud is clustered to the
    binner's contract (chunk-bbox decomposition relies on spatial
    coherence, as in every bench scene): 430 clusters of 256 heavily
    z-overlapping triangles. The kernel and the oracle may fuse mul+add
    chains differently, so up to 200 pixels may flip — each must be a
    depth tie or a cover-boundary flip (raster_ref.unexplained_
    mismatches); agreeing pixels match in depth to a few ulps."""
    import jax

    from trident.ops.raster import visibility
    from trident.ops.raster_ref import unexplained_mismatches

    w, h = 1920, 1080
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
    setup = _setup(_clip(pos, ww), w, h)
    rt, rd = _oracle_in_bands(setup, w, h, 135)
    got = jax.jit(lambda s: visibility(s, w, h, interpret=False))(setup)
    aux = np.asarray(got.aux)
    assert aux.sum() == 0, f"capacity overflow at bench scale: {aux}"
    pt, pd = np.asarray(got.tri_id), np.asarray(got.depth)
    mism = rt != pt
    print(f"110k parity: {int(mism.sum())} winner mismatches", flush=True)
    assert mism.sum() <= 200, f"{int(mism.sum())} winner mismatches"
    bad = unexplained_mismatches(setup, rt, rd, pt, pd)
    assert not bad, f"{len(bad)} non-tie non-boundary mismatches: {bad[:5]}"
    np.testing.assert_allclose(rd[~mism], pd[~mism], rtol=1e-6, atol=1e-7)


def test_depth_only_pass_matches_full_kernel_on_gpu(gpu_device):
    """The shadow pass's depth-only kernel gives the full kernel's depth
    plane bit for bit (a plain min merge vs the lexicographic one)."""
    import jax

    from trident.ops.raster import visibility

    w, h = 512, 288
    rng = np.random.default_rng(5)
    t = 4096
    pos = (rng.uniform(-1, 1, (t, 1, 3)) * [0.9, 0.9, 0.4]
           + rng.uniform(-0.05, 0.05, (t, 3, 3)))
    ww = np.ones((t, 3, 1), np.float32) * rng.uniform(0.5, 2.0, (t, 1, 1))
    setup = _setup(_clip(pos, ww), w, h)
    full = jax.jit(lambda s: visibility(s, w, h, interpret=False))(setup)
    depth = jax.jit(lambda s: visibility(s, w, h, interpret=False,
                                         depth_only=True))(setup)
    np.testing.assert_array_equal(np.asarray(full.depth),
                                  np.asarray(depth.depth))


def test_golden_flavors_on_gpu(gpu_device):
    """All nine golden pipeline flavors rendered on the card through the
    binned kernel, against the CPU goldens: at most 1% of pixels off by
    more than 3 LSB and a mean of at most 1 LSB (float32 products may run
    in TF32 on the card, and fma fusion differs from the CPU)."""
    sys.path.insert(0, os.path.dirname(__file__))
    import test_golden_flavors as tg
    from trident.io.image import load_rgba8

    orig_make = tg._make

    def kernel_make(**kw):
        kw["use_pallas"] = True
        return orig_make(**kw)

    tg._make = kernel_make
    try:
        failures = []
        for name, builder in sorted(tg.FLAVORS.items()):
            img = builder().read_frame()
            golden = load_rgba8(
                os.path.join(tg.GOLDEN_DIR, f"flavor_{name}.png"))
            diff = np.abs(img.astype(int) - golden.astype(int))
            frac, mean = float((diff > 3).mean()), float(diff.mean())
            print(f"flavor {name}: >3LSB frac={frac:.5f} mean={mean:.3f}",
                  flush=True)
            if frac > 0.01 or mean > 1.0:
                failures.append((name, frac, mean))
        assert not failures, f"flavor drift on the card: {failures}"
    finally:
        tg._make = orig_make


def test_bench_configs_zero_overflow_on_gpu(gpu_device):
    """aux == [0,0] at every bench config on the card — the capacity
    headroom behind the published FPS numbers."""
    sys.path.insert(0, ROOT)
    import bench

    for config in ("cube512", "spheres1080", "spheres1080_1m", "ultra4k",
                   "shadows1080"):
        renderer, _, _ = bench.build_scene(config)
        out = renderer.render_viewport(renderer.active_viewport)
        aux = np.asarray(out.aux).reshape(-1, 2).sum(axis=0)
        print(f"{config}: aux={aux.tolist()}", flush=True)
        assert aux.sum() == 0, f"{config}: overflow {aux.tolist()}"
