"""Neural 2× super-resolution mode (ai/upscaler.py + RenderConfig.ai_upscale)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp


def test_net_shapes_and_range():
    from trident.ai.upscaler import UpscalerNet, init_upscaler

    model, variables = init_upscaler(jax.random.PRNGKey(0), base_channels=8)
    x = jnp.linspace(0, 1, 24 * 16 * 3).reshape(1, 24, 16, 3)
    out = model.apply(variables, x)
    assert out.shape == (1, 48, 32, 3)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0


def test_checkpoint_roundtrip_and_apply(tmp_path):
    from trident.ai.upscaler import (
        apply_upscaler, init_upscaler, load_upscaler, save_upscaler)

    _, variables = init_upscaler(jax.random.PRNGKey(1), base_channels=8)
    save_upscaler(jax.device_get(variables["params"]), str(tmp_path))
    params, bc = load_upscaler(str(tmp_path))
    assert bc == 8
    img = jnp.zeros((16, 16, 3), jnp.float32)
    out = apply_upscaler(params, img)       # channel width inferred
    assert out.shape == (32, 32, 3)


def _scene(tmp_path, upscaler_path, kernel=None):
    from trident.core.config import AiConfig, EngineConfig, RenderConfig
    from trident.ecs.components import (
        MeshComponent, TextureComponent, TransformComponent)
    from trident.ecs.registry import Registry
    from trident.geometry.primitives import PrimitiveType
    from trident.io.image import checkerboard
    from trident.render.renderer import Renderer

    r = Renderer(EngineConfig(
        render=RenderConfig(width=64, height=64, ai_upscale=True,
                            kernel=kernel or {}),
        ai=AiConfig(upscaler_path=upscaler_path)))
    reg = Registry()
    r.set_active_registry(reg)
    slot = r.acquire_texture("checker", checkerboard(32, 4))
    e = reg.create()
    reg.add(e, TransformComponent())
    reg.add(e, MeshComponent(mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
    reg.add(e, TextureComponent(path="checker", slot=slot))
    r.editor_camera.set_position([0, 0, 3])
    r.editor_camera.look_at_target([0, 0, 0])
    return r


def test_renderer_upscale_mode(tmp_path):
    from trident.ai.upscaler import init_upscaler, save_upscaler

    _, variables = init_upscaler(jax.random.PRNGKey(2), base_channels=8)
    save_upscaler(jax.device_get(variables["params"]), str(tmp_path))
    r = _scene(tmp_path, str(tmp_path))
    frame = r.read_frame()
    assert frame.shape == (64, 64, 4)           # full target size
    out = r.viewports[0].last_frame
    assert np.asarray(out.depth).shape == (64, 64)
    assert np.asarray(out.tri_id).shape == (64, 64)
    assert (np.asarray(out.tri_id) >= 0).sum() > 0
    # an untrained residual net stays near its bilinear base: the cube
    # must still be recognizably there (non-background luminance)
    assert frame[..., :3].max() > 60


def test_renderer_upscale_missing_checkpoint_degrades(tmp_path):
    """A frame asked to reconstruct with a checkpoint that cannot load is
    an error, not a silent native-res render."""
    r = _scene(tmp_path, str(tmp_path / "nope"))
    with pytest.raises(FileNotFoundError):
        r.read_frame()
    assert r._upscaler_params is None


def test_temporal_net_and_warp_identity():
    """Temporal path: with an identical camera, warp_previous must return
    the previous frame's own 2×2 blocks (s2d identity) with valid=1 on
    geometry pixels, and the temporal net must accept the 16-ch input."""
    from trident.ai.upscaler import (
        TEMPORAL_CHANNELS, apply_upscaler, init_upscaler, warp_previous)
    from trident.render.camera import EditorCamera

    cam = EditorCamera()
    cam.set_viewport_size(32, 32)
    cam.set_position([0, 0, 3])
    cam.look_at_target([0, 0, 0])
    p = cam.params()
    vp = np.asarray(p.proj) @ np.asarray(p.view)

    rng = np.random.default_rng(7)
    prev = rng.random((32, 32, 3)).astype(np.float32)
    depth = np.full((16, 16), 0.5, np.float32)   # geometry everywhere
    out = np.asarray(warp_previous(
        jnp.asarray(prev), jnp.asarray(depth),
        jnp.asarray(np.linalg.inv(vp).astype(np.float32)),
        jnp.asarray(vp.astype(np.float32)), 32, 32))
    assert out.shape == (16, 16, 13)
    np.testing.assert_allclose(out[..., 12], 1.0)          # all valid
    s2d = prev.reshape(16, 2, 16, 2, 3).transpose(0, 2, 1, 3, 4) \
        .reshape(16, 16, 12)
    np.testing.assert_allclose(out[..., :12], s2d, atol=1e-5)

    # background pixels (depth==1) are invalid → zeros
    out_bg = np.asarray(warp_previous(
        jnp.asarray(prev), jnp.ones((16, 16), np.float32),
        jnp.asarray(np.linalg.inv(vp).astype(np.float32)),
        jnp.asarray(vp.astype(np.float32)), 32, 32))
    np.testing.assert_allclose(out_bg, 0.0)

    # the temporal net consumes the concatenated input
    _, variables = init_upscaler(jax.random.PRNGKey(0), base_channels=8,
                                 in_channels=TEMPORAL_CHANNELS)
    up = apply_upscaler(variables["params"], jnp.asarray(prev[::2, ::2]),
                        jnp.asarray(out))
    assert up.shape == (32, 32, 3)
    # zero-init head: no-history call equals the bilinear base path too
    up_nohist = apply_upscaler(variables["params"],
                               jnp.asarray(prev[::2, ::2]))
    np.testing.assert_allclose(np.asarray(up), np.asarray(up_nohist),
                               atol=1e-6)


def test_temporal_checkpoint_roundtrip(tmp_path):
    from trident.ai.upscaler import (
        TEMPORAL_CHANNELS, init_upscaler, load_upscaler, save_upscaler,
        upscaler_in_channels)

    _, variables = init_upscaler(jax.random.PRNGKey(3), base_channels=8,
                                 in_channels=TEMPORAL_CHANNELS)
    save_upscaler(jax.device_get(variables["params"]), str(tmp_path))
    params, _bc = load_upscaler(str(tmp_path))
    assert upscaler_in_channels(params) == TEMPORAL_CHANNELS


def test_renderer_temporal_upscale_chains_frames(tmp_path):
    """Renderer plumbing: a temporal checkpoint renders frame-to-frame,
    the second frame consuming the first as history (prev_state)."""
    from trident.ai.upscaler import (
        TEMPORAL_CHANNELS, init_upscaler, save_upscaler)

    _, variables = init_upscaler(jax.random.PRNGKey(4), base_channels=8,
                                 in_channels=TEMPORAL_CHANNELS)
    save_upscaler(jax.device_get(variables["params"]), str(tmp_path))
    r = _scene(tmp_path, str(tmp_path))
    f0 = r.read_frame()
    assert r.viewports[0].prev_state is not None
    r.editor_camera.orbit([0, 0, 0], 10.0, 0.0)
    f1 = r.read_frame()
    assert f1.shape == (64, 64, 4)
    assert (f0 != f1).any()


def test_shipped_checkpoint_beats_bilinear_psnr(tmp_path):
    """Quality gate on the SHIPPED checkpoint (assets_out/upscaler_2x):
    on a held-out render pair the net must reconstruct the full-res frame
    measurably better than plain bilinear upsampling. Guards against
    shipping a regressed/unconverged checkpoint (reference quality gate:
    Scripts/train_frame_generator.py's PSNR validation)."""
    import os

    from trident.ai.upscaler import (
        apply_upscaler, load_upscaler, psnr, upscaler_in_channels,
        TEMPORAL_CHANNELS, warp_previous)

    ckpt = os.path.join(os.path.dirname(__file__), "..",
                        "assets_out", "upscaler_2x")
    if not os.path.isdir(ckpt):
        pytest.skip("shipped upscaler checkpoint not present")
    params, _bc = load_upscaler(ckpt)

    # held-out pair: same scene rendered full-res (target) and half-res
    # (input) — the exact runtime contract of ai_upscale mode
    # 128→256 is the training contract scale (train_upscaler.py --res 256);
    # at 64→128 the input is far more aliased than anything the net saw and
    # it measures ~0.4 dB below bilinear — that's distribution, not a
    # regressed checkpoint, so the gate tests the scale the mode ships at.
    r = _scene(tmp_path, str(tmp_path / "unused"))
    r.config.render.ai_upscale = False
    r.set_viewport(0, 256, 256)
    target = np.asarray(r.read_frame())[..., :3].astype(np.float32) / 255.0
    full_out = r.viewports[0].last_frame
    cam = r.editor_camera.params()
    vp = (np.asarray(cam.proj) @ np.asarray(cam.view)).astype(np.float32)
    r.set_viewport(0, 128, 128)
    r.read_frame()
    half = np.asarray(r.viewports[0].last_frame.color)[..., :3]
    half = half.astype(np.float32) / 255.0

    bilinear = jax.image.resize(jnp.asarray(half), (256, 256, 3), "bilinear")
    if upscaler_in_channels(params) == TEMPORAL_CHANNELS:
        # temporal net: feed the previous full-res frame (the target's own
        # render works — static camera, identity warp) as history
        prev = np.asarray(full_out.color)[..., :3].astype(np.float32) / 255.0
        depth = np.asarray(r.viewports[0].last_frame.depth)
        hist = warp_previous(jnp.asarray(prev), jnp.asarray(depth),
                             jnp.asarray(np.linalg.inv(vp)), jnp.asarray(vp),
                             256, 256)
        net = apply_upscaler(params, jnp.asarray(half), hist)
    else:
        net = apply_upscaler(params, jnp.asarray(half))

    tgt = jnp.asarray(target)
    p_net = float(psnr(net, tgt))
    p_bil = float(psnr(jnp.clip(bilinear, 0, 1), tgt))
    assert p_net > p_bil + 0.2, (
        f"shipped upscaler {p_net:.2f} dB vs bilinear {p_bil:.2f} dB — "
        "checkpoint regressed below the +0.2 dB gate")


def test_depth_channel_layouts(tmp_path):
    """4 (rgb+depth) and 17 (rgb+depth+temporal) channel checkpoints:
    wants_* detection, apply with/without the depth input, and the
    renderer end-to-end (depth rides in from the half-res G-buffer)."""
    from trident.ai.upscaler import (
        apply_upscaler, init_upscaler, save_upscaler, upscaler_wants_depth,
        upscaler_wants_temporal)

    for in_ch, wants_t in ((4, False), (17, True)):
        _, variables = init_upscaler(jax.random.PRNGKey(3), base_channels=8,
                                     in_channels=in_ch)
        params = variables["params"]
        assert upscaler_wants_depth(params)
        assert upscaler_wants_temporal(params) == wants_t
        img = jnp.linspace(0, 1, 16 * 16 * 3).reshape(16, 16, 3)
        d = jnp.full((16, 16), 0.25, jnp.float32)
        out = apply_upscaler(params, img, depth=d)
        assert out.shape == (32, 32, 3)
        # missing depth degrades to the background plane, not a crash
        out2 = apply_upscaler(params, img)
        assert out2.shape == (32, 32, 3)

    # renderer end-to-end with a depth-channel checkpoint
    _, variables = init_upscaler(jax.random.PRNGKey(4), base_channels=8,
                                 in_channels=4)
    save_upscaler(jax.device_get(variables["params"]), str(tmp_path))
    r = _scene(tmp_path, str(tmp_path))
    frame = r.read_frame()
    assert frame.shape == (64, 64, 4)
    assert frame[..., :3].max() > 60


# ---- V2 reconstruction path: block-layout history, no 4K relayouts ----


def test_d2s_modes_bit_exact():
    """All depth_to_space modes are exact relayouts: the one-hot
    conv_transpose (HIGHEST) and the zero-interleave pad+add must equal
    the reference reshape/transpose BIT-FOR-BIT."""
    from trident.ai.upscaler import depth_to_space

    rng = np.random.default_rng(11)
    blocks = jnp.asarray(rng.random((24, 40, 12), np.float32))
    ref = np.asarray(depth_to_space(blocks, mode="xla"))
    assert ref.shape == (48, 80, 3)
    for mode in ("convt", "pad"):
        out = np.asarray(depth_to_space(blocks, mode=mode))
        assert (out != ref).sum() == 0, mode


def test_base_blocks_matches_resize():
    """The block-layout bilinear base (four phase-shifted half-res lerps)
    equals jax.image.resize's 2x bilinear up to f32 association."""
    from trident.ai.upscaler import base_blocks, depth_to_space

    rng = np.random.default_rng(12)
    img = jnp.asarray(rng.random((32, 48, 3), np.float32))
    via_blocks = np.asarray(depth_to_space(base_blocks(img), mode="xla"))
    ref = np.asarray(jax.image.resize(img, (64, 96, 3), "bilinear"))
    np.testing.assert_allclose(via_blocks, ref, atol=1e-6)


def test_v2_matches_v1_at_f32():
    """apply_upscaler_v2 (f32 compute) must reproduce apply_upscaler on
    non-trivial weights: same convs, residual re-associated into block
    layout, one exact depth_to_space."""
    from trident.ai import upscaler as up
    from trident.ops import kernel_knobs

    _, variables = up.init_upscaler(jax.random.PRNGKey(5), base_channels=8,
                                    in_channels=17)
    # perturb the zero-init head so the residual is exercised
    params = jax.tree.map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(6),
                                               a.shape, a.dtype),
        variables["params"])
    rng = np.random.default_rng(13)
    img = jnp.asarray(rng.random((16, 24, 3), np.float32))
    temporal = jnp.asarray(rng.random((16, 24, 13), np.float32))
    d = jnp.asarray(rng.random((16, 24), np.float32))
    v1 = np.asarray(up.apply_upscaler(params, img, temporal, d))
    with kernel_knobs.overrides(upscale_dtype="f32"):
        rgb, blocks = up.apply_upscaler_v2(params, img, temporal, d)
    assert blocks.shape == (16, 24, 12)
    np.testing.assert_allclose(np.asarray(rgb), v1, atol=2e-6)


def test_warp_from_blocks_matches_warp_previous():
    """Given equal history VALUES (blocks = s2d of the full-res frame),
    the V2 warp must be bit-identical to the V1 warp — same reprojection,
    same gather, no space-to-depth."""
    from trident.ai.upscaler import warp_from_blocks, warp_previous
    from trident.render.camera import EditorCamera

    cam = EditorCamera()
    cam.set_viewport_size(32, 32)
    cam.set_position([0, 0, 3])
    cam.look_at_target([0, 0, 0])
    p0 = cam.params()
    vp0 = (np.asarray(p0.proj) @ np.asarray(p0.view)).astype(np.float32)
    cam.orbit([0, 0, 0], 7.0, 3.0)           # a real inter-frame motion
    p1 = cam.params()
    vp1 = (np.asarray(p1.proj) @ np.asarray(p1.view)).astype(np.float32)

    rng = np.random.default_rng(14)
    prev = rng.random((32, 32, 3)).astype(np.float32)
    blocks = prev.reshape(16, 2, 16, 2, 3).transpose(0, 2, 1, 3, 4) \
        .reshape(16, 16, 12)
    depth = rng.uniform(0.3, 0.7, (16, 16)).astype(np.float32)
    inv = np.linalg.inv(vp1).astype(np.float32)
    v1 = np.asarray(warp_previous(
        jnp.asarray(prev), jnp.asarray(depth), jnp.asarray(inv),
        jnp.asarray(vp0), 32, 32))
    v2 = np.asarray(warp_from_blocks(
        jnp.asarray(blocks), jnp.asarray(depth), jnp.asarray(inv),
        jnp.asarray(vp0), 32, 32))
    assert (v1 != v2).sum() == 0


def test_renderer_v2_history_and_parity(tmp_path):
    """Renderer end-to-end: with V2 on (default) the temporal mode keeps
    (h, w, 12) uint8 blocks as prev_state and chains frames; the first
    frame matches the V1 path within 1 uint8 LSB (association-only
    differences at f32 compute)."""
    from trident.ai.upscaler import (
        TEMPORAL_CHANNELS, init_upscaler, save_upscaler)
    from trident.ops import kernel_knobs

    _, variables = init_upscaler(jax.random.PRNGKey(7), base_channels=8,
                                 in_channels=TEMPORAL_CHANNELS)
    save_upscaler(jax.device_get(variables["params"]), str(tmp_path))

    # knobs must ride RenderConfig.kernel: Renderer.__init__ resets the
    # registry from env defaults (the round-4 leak fix), so a bare
    # overrides() context would be stomped at construction
    r = _scene(tmp_path, str(tmp_path),
               kernel={"upscale_v2": True, "upscale_dtype": "f32"})
    f0 = np.asarray(r.read_frame())
    hist = r.viewports[0].prev_state[0]
    assert hist.shape == (32, 32, 12) and hist.dtype == jnp.uint8
    r.editor_camera.orbit([0, 0, 0], 10.0, 0.0)
    f1 = np.asarray(r.read_frame())
    assert (f0 != f1).any()

    r1 = _scene(tmp_path, str(tmp_path), kernel={"upscale_v2": False})
    g0 = np.asarray(r1.read_frame())
    assert r1.viewports[0].prev_state[0].shape[-1] == 4  # packed color
    assert np.abs(f0.astype(int) - g0.astype(int)).max() <= 1


def test_v2_bf16_quality_close_to_f32(tmp_path):
    """bf16 conv compute (the V2 default) must not visibly regress
    quality: PSNR(v2_bf16, v2_f32) on a non-trivial net stays high."""
    from trident.ai import upscaler as up
    from trident.ops import kernel_knobs

    _, variables = up.init_upscaler(jax.random.PRNGKey(8), base_channels=8,
                                    in_channels=17)
    params = jax.tree.map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(9),
                                               a.shape, a.dtype),
        variables["params"])
    rng = np.random.default_rng(15)
    img = jnp.asarray(rng.random((32, 32, 3), np.float32))
    temporal = jnp.asarray(rng.random((32, 32, 13), np.float32))
    d = jnp.asarray(rng.random((32, 32), np.float32))
    with kernel_knobs.overrides(upscale_dtype="f32"):
        rgb32, _ = up.apply_upscaler_v2(params, img, temporal, d)
    with kernel_knobs.overrides(upscale_dtype="bf16"):
        rgb16, _ = up.apply_upscaler_v2(params, img, temporal, d)
    p = float(up.psnr(rgb16, rgb32))
    assert p > 40.0, f"bf16 vs f32 PSNR {p:.1f} dB"
