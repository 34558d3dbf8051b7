"""Plain-JAX layers, checkpoints and optimizer state of the two nets
(ai/nn.py) against direct numpy / lax references."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from trident.ai import nn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _conv_np(x, k, b, stride):
    """Direct 'same'-padded NHWC × HWIO convolution."""
    kh = k.shape[0]
    pad = kh // 2
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    n, h, w, _ = x.shape
    ho, wo = -(-h // stride), -(-w // stride)
    out = np.zeros((n, ho, wo, k.shape[-1]), np.float64)
    for i in range(ho):
        for j in range(wo):
            patch = xp[:, i * stride:i * stride + kh, j * stride:j * stride + kh]
            out[:, i, j] = np.einsum("nhwc,hwco->no", patch, k)
    return out + b


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_matches_numpy(stride):
    rng = np.random.default_rng(stride)
    x = rng.normal(size=(2, 8, 6, 3)).astype(np.float32)
    p = {"kernel": rng.normal(size=(3, 3, 3, 5)).astype(np.float32),
         "bias": rng.normal(size=(5,)).astype(np.float32)}
    got = nn.conv(jax.tree.map(jnp.asarray, p), jnp.asarray(x), stride)
    np.testing.assert_allclose(np.asarray(got),
                               _conv_np(x, p["kernel"], p["bias"], stride),
                               rtol=1e-4, atol=1e-4)


def test_conv_transpose_doubles_and_adds_bias():
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(size=(1, 4, 5, 3)).astype(np.float32))
    p = {"kernel": jnp.zeros((4, 4, 3, 2), jnp.float32),
         "bias": jnp.asarray([0.5, -1.0], jnp.float32)}
    y = nn.conv_transpose(p, x)
    assert y.shape == (1, 8, 10, 2)
    np.testing.assert_allclose(np.asarray(y[..., 0]), 0.5)
    np.testing.assert_allclose(np.asarray(y[..., 1]), -1.0)


def test_batch_norm_training_statistics():
    rng = np.random.default_rng(5)
    x = rng.normal(3.0, 2.0, size=(4, 5, 6, 3)).astype(np.float32)
    p, stats = nn.init_batch_norm(3)
    y, new = nn.batch_norm(p, stats, jnp.asarray(x), train=True)
    mean, var = x.mean(axis=(0, 1, 2)), x.var(axis=(0, 1, 2))
    np.testing.assert_allclose(np.asarray(y), (x - mean) / np.sqrt(
        var + nn.BN_EPS), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(new["mean"]),
                               (1 - nn.BN_MOMENTUM) * mean, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(new["var"]), nn.BN_MOMENTUM
                               + (1 - nn.BN_MOMENTUM) * var, rtol=1e-5)


def test_batch_norm_inference_uses_running_stats():
    p = {"scale": jnp.asarray([2.0]), "bias": jnp.asarray([1.0])}
    stats = {"mean": jnp.asarray([0.5]), "var": jnp.asarray([4.0])}
    x = jnp.full((1, 2, 2, 1), 2.5)
    y, same = nn.batch_norm(p, stats, x, train=False)
    np.testing.assert_allclose(np.asarray(y),
                               2.0 * 2.0 / np.sqrt(4.0 + nn.BN_EPS) + 1.0,
                               rtol=1e-6)
    assert same is stats


def test_npz_roundtrip(tmp_path):
    tree = {"a": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "b": {"c": {"bias": np.ones(2, np.float32)}}}
    path = nn.save_npz(str(tmp_path / "t.npz"), tree)
    back = nn.load_npz(path)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(jnp.asarray, tree))
    np.testing.assert_array_equal(np.asarray(back["a"]["kernel"]),
                                  tree["a"]["kernel"])


def test_train_state_applies_optax_update():
    params = {"w": jnp.asarray([1.0, -2.0])}
    tx = optax.sgd(0.5)
    state = nn.TrainState.create(apply_fn=None, params=params, tx=tx)
    new = state.apply_gradients(grads={"w": jnp.asarray([2.0, 2.0])})
    np.testing.assert_allclose(np.asarray(new.params["w"]), [0.0, -3.0])
    assert int(new.step) == 1


def test_train_state_is_a_pytree_under_jit():
    state = nn.TrainState.create(apply_fn=None,
                                 params={"w": jnp.ones(3)},
                                 tx=optax.adam(1e-2))
    step = jax.jit(lambda s: s.apply_gradients(
        grads={"w": jnp.ones(3)}))
    out = step(step(state))
    assert int(out.step) == 2 and out.tx is state.tx


@pytest.mark.parametrize("name,want", [
    ("upscaler_2x/params.npz", {"Conv_0": (3, 3, 16, 32)}),
    ("frame_generator_128/step_000059.npz", {"Conv_0": (3, 3, 6, 16)}),
])
def test_shipped_checkpoints_load(name, want):
    tree = nn.load_npz(os.path.join(ROOT, "assets_out", name))
    for layer, shape in want.items():
        assert tree["params"][layer]["kernel"].shape == shape


def _interp_net():
    from trident.ai.train import load_checkpoint

    return load_checkpoint(os.path.join(ROOT, "assets_out",
                                        "frame_generator_128"))


@pytest.mark.parametrize("net", ["interp", "upscaler"])
def test_shipped_nets_match_flax_reference(net):
    """tests/goldens/ai_nets_flax_ref.npz holds both shipped checkpoints'
    outputs on these seeded inputs, computed by the flax implementation
    the plain-JAX nets replaced (CPU, float32, HIGHEST precision). A
    wrong conv_transpose padding, batch-norm layout or parameter-key
    mapping moves them."""
    from trident.ai.upscaler import apply_upscaler, load_upscaler

    rng = np.random.default_rng(0)
    x_interp = rng.uniform(size=(1, 32, 32, 6)).astype(np.float32)
    img = rng.uniform(size=(16, 24, 3)).astype(np.float32)
    temporal = rng.uniform(size=(16, 24, 13)).astype(np.float32)
    want = np.load(os.path.join(ROOT, "tests", "goldens",
                                "ai_nets_flax_ref.npz"))[net]
    with jax.default_matmul_precision("highest"):
        if net == "interp":
            model, variables = _interp_net()
            got = model.apply(variables, jnp.asarray(x_interp), train=False)
        else:
            params, _ = load_upscaler(os.path.join(ROOT, "assets_out",
                                                   "upscaler_2x"))
            got = apply_upscaler(params, jnp.asarray(img),
                                 jnp.asarray(temporal))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


def test_bench_interp_psnr_matches_recorded_value(monkeypatch):
    """bench_interp's PSNR vs the middle frame is the number chip_smoke
    checks on the card; on the CPU it must be the recorded value."""
    monkeypatch.syspath_prepend(ROOT)
    monkeypatch.setenv("BENCH_INTERP_CKPT",
                       os.path.join(ROOT, "assets_out", "frame_generator_128"))
    import bench

    res = bench.bench_interp(iters=1)
    assert res["extra"]["finite"]
    assert abs(res["extra"]["psnr_db_vs_middle_frame"]
               - bench.INTERP_PSNR_DB) < 1e-3
