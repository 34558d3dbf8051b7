"""AI subsystem: U-Net shapes, metrics, trainer loop, frame generator."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from trident.ai.dataset import TripletDataset, list_frames
from trident.ai.metrics import psnr, ssim
from trident.ai.model import init_model
from trident.ai.train import TrainConfig, train

REF_DATASET = "/root/reference/Dataset"


def make_frames(tmp_path, n=6, size=32):
    from trident.io.image import save_png

    rng = np.random.default_rng(0)
    base = rng.random((size, size, 3)).astype(np.float32)
    for i in range(n):
        # smoothly drifting pattern so interpolation is learnable
        img = np.roll(base, shift=i, axis=1)
        save_png(str(tmp_path / f"frame_{i:04d}.png"), img)
    return str(tmp_path)


def test_unet_shapes():
    model, variables = init_model(jax.random.PRNGKey(0), (32, 32), base_channels=8)
    x = jnp.zeros((2, 32, 32, 6))
    out = model.apply(variables, x, train=False)
    assert out.shape == (2, 32, 32, 3)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0  # sigmoid


def test_metrics_identity():
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.random((1, 32, 32, 3)), jnp.float32)
    assert float(psnr(img, img)) > 70.0
    assert float(ssim(img, img)) > 0.99
    noisy = jnp.clip(img + 0.2, 0, 1)
    assert float(psnr(img, noisy)) < 20.0


def test_dataset_triplets(tmp_path):
    make_frames(tmp_path, n=6, size=16)
    ds = TripletDataset(str(tmp_path), resolution=(16, 16))
    assert len(ds) == 4
    inp, target = ds.sample(0)
    assert inp.shape == (16, 16, 6) and target.shape == (16, 16, 3)
    train_idx, val_idx = ds.split(0.25)
    assert len(val_idx) >= 1 and len(train_idx) + len(val_idx) == 4


def test_trainer_improves_and_checkpoints(tmp_path):
    (tmp_path / "frames").mkdir(exist_ok=True)
    src = make_frames(tmp_path / "frames", n=8, size=16)
    cfg = TrainConfig(source=src, resolution=(16, 16), base_channels=4,
                      batch_size=2, epochs=2, val_fraction=0.3,
                      checkpoint_dir=str(tmp_path / "ckpt"),
                      checkpoint_every=0, learning_rate=1e-3)
    summary = train(cfg)
    assert summary["epochs_run"] == 2
    assert summary["best_psnr"] > 0
    assert summary["checkpoint"] and os.path.exists(summary["checkpoint"])
    # restore and run inference
    from trident.ai.train import load_checkpoint

    model, variables = load_checkpoint(str(tmp_path / "ckpt"), cfg)
    out = model.apply(variables, jnp.zeros((1, 16, 16, 6)), train=False)
    assert out.shape == (1, 16, 16, 3)


@pytest.mark.skipif(not os.path.isdir(REF_DATASET),
                    reason="reference dataset not mounted")
def test_trainer_on_reference_dataset(tmp_path):
    """One epoch at small res on the real captured frames (the reference's
    Train-Frame-Generator workflow)."""
    cfg = TrainConfig(source=REF_DATASET, resolution=(32, 32), base_channels=4,
                      batch_size=4, epochs=1, val_fraction=0.15,
                      checkpoint_dir=str(tmp_path / "ckpt"))
    summary = train(cfg)
    assert summary["epochs_run"] == 1
    assert summary["best_psnr"] > 10.0   # even one epoch beats noise (≈8 dB)


def test_frame_generator_worker():
    from trident.ai.frame_generator import FrameGenerator
    from trident.ai.model import init_model

    model, variables = init_model(jax.random.PRNGKey(0), (16, 16), base_channels=4)
    gen = FrameGenerator(resolution=(16, 16))
    assert gen.initialise(model=model, variables=variables)
    rng = np.random.default_rng(0)
    f0 = rng.random((16, 16, 3)).astype(np.float32)
    assert gen.process_frame(f0) is None          # first frame has no pair
    idx = gen.process_frame(rng.random((16, 16, 3)).astype(np.float32))
    assert idx == 0
    import time

    result = None
    for _ in range(100):
        result = gen.try_consume_output()
        if result is not None:
            break
        time.sleep(0.05)
    assert result is not None
    out_idx, frame = result
    assert out_idx == 0 and frame.shape == (16, 16, 3)
    assert gen.stats.completed_count == 1
    assert gen.stats.last_inference_ms > 0
    gen.shutdown()


def test_sprite_rendering():
    from trident.core.config import EngineConfig, RenderConfig
    from trident.ecs.components import SpriteComponent, TransformComponent
    from trident.ecs.registry import Registry
    from trident.io.image import checkerboard
    from trident.render.renderer import Renderer

    r = Renderer(EngineConfig(render=RenderConfig(width=64, height=64,
                                                  use_pallas=False)))
    reg = Registry()
    r.set_active_registry(reg)
    slot = r.acquire_texture("spr", checkerboard(32, 2,
                                                 color_a=(255, 0, 0, 255),
                                                 color_b=(0, 255, 0, 255)))
    e = reg.create()
    reg.add(e, TransformComponent())
    spr = reg.add(e, SpriteComponent(texture_path="spr", texture_slot=slot))
    spr.atlas_tiles = 2
    spr.atlas_index = 0
    r.editor_camera.set_position([0, 0, 1.2])
    r.editor_camera.look_at_target([0, 0, 0])
    img = r.read_frame()
    out = r.viewports[0].last_frame
    assert (np.asarray(out.tri_id) >= 0).any()
    # atlas tile 0 is the red cell → red should dominate the sprite area
    center = img[20:44, 20:44, :3].astype(int)
    assert center[..., 0].mean() > center[..., 2].mean()


def test_periodic_checkpoint_keeps_best_latest(tmp_path):
    """latest.json must keep pointing at the early-stopping BEST model:
    periodic resume snapshots save their step dir without retargeting it
    (every loader resolves through latest.json)."""
    import json

    import optax

    from trident.ai.model import init_model
    from trident.ai.train import TrainState, save_checkpoint

    model, variables = init_model(jax.random.PRNGKey(0),
                                  resolution=(32, 32), base_channels=8)
    state = TrainState.create(
        apply_fn=model.apply, params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        tx=optax.adam(1e-3))
    best = save_checkpoint(state, str(tmp_path), 3)
    save_checkpoint(state, str(tmp_path), 7, update_latest=False)
    with open(tmp_path / "latest.json") as f:
        latest = json.load(f)
    assert latest["step"] == 3
    assert latest["path"] == "step_000003.npz"
    assert best.endswith("step_000003.npz")
