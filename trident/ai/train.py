"""Frame-interpolation trainer: L1 + Adam, PSNR/SSIM eval, early stopping,
`.npz` checkpoints.

Reference: Scripts/train_frame_generator.py main loop (:462-573) — L1 loss,
Adam, per-epoch PSNR/SSIM on a validation split, early stop on best PSNR,
periodic checkpoints, JSON-lines logs. Here a checkpoint is one `.npz`
of the params and batch statistics (the ONNX-export step disappears:
inference shares the chip with the renderer, see ai/frame_generator.py).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
import optax

from trident.ai.dataset import TripletDataset
from trident.ai.metrics import psnr, ssim
from trident.ai.model import init_model
from trident.ai.nn import TrainState, load_npz, save_npz
from trident.core.log import get_logger

logger = get_logger("ai.train")


@dataclass
class TrainConfig:
    source: str = "Dataset"
    resolution: Tuple[int, int] = (256, 256)
    base_channels: int = 32
    batch_size: int = 4
    learning_rate: float = 2e-4
    epochs: int = 50
    val_fraction: float = 0.1
    early_stop_patience: int = 8
    checkpoint_dir: str = "checkpoints/frame_generator"
    checkpoint_every: int = 5
    seed: int = 0
    log_path: Optional[str] = None
    skip_training: bool = False   # CI path: init + save untrained, like --skip-training


def create_state(config: TrainConfig, bn_axis_name: Optional[str] = None) -> TrainState:
    rng = jax.random.PRNGKey(config.seed)
    model, variables = init_model(rng, config.resolution, config.base_channels,
                                  bn_axis_name=bn_axis_name)
    return TrainState.create(
        apply_fn=model.apply,
        params=variables["params"],
        batch_stats=variables.get("batch_stats"),
        tx=optax.adam(config.learning_rate),
    )


def l1_loss(prediction: jax.Array, target: jax.Array) -> jax.Array:
    return jnp.mean(jnp.abs(prediction - target))


def train_step(state: TrainState, inputs: jax.Array, targets: jax.Array,
               axis_name: Optional[str] = None):
    """One optimizer step. Pure: jit/pjit-able; pass axis_name when run
    under shard_map/pmap-style data parallelism to psum grads."""

    def loss_fn(params):
        out, mutated = state.apply_fn(
            {"params": params, "batch_stats": state.batch_stats},
            inputs, train=True, mutable=["batch_stats"])
        return l1_loss(out, targets), (out, mutated["batch_stats"])

    (loss, (out, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    if axis_name is not None:
        grads = jax.lax.pmean(grads, axis_name)
        loss = jax.lax.pmean(loss, axis_name)
    state = state.apply_gradients(grads=grads)
    state = state.replace(batch_stats=new_stats)
    return state, loss, out


def eval_step(state: TrainState, inputs: jax.Array, targets: jax.Array):
    out = state.apply_fn(
        {"params": state.params, "batch_stats": state.batch_stats},
        inputs, train=False)
    return l1_loss(out, targets), psnr(out, targets), ssim(out, targets)


def save_checkpoint(state: TrainState, directory: str, step: int,
                    update_latest: bool = True) -> str:
    """`update_latest=False` writes the step dir WITHOUT retargeting
    latest.json — periodic resume snapshots must not displace the
    early-stopping BEST model that every loader (load_checkpoint,
    validate.py, FrameGenerator, bench) resolves through latest.json."""
    os.makedirs(directory, exist_ok=True)
    path = save_npz(os.path.abspath(os.path.join(directory,
                                                 f"step_{step:06d}.npz")),
                    {"params": jax.device_get(state.params),
                     "batch_stats": jax.device_get(state.batch_stats)})
    if update_latest:
        with open(os.path.join(directory, "latest.json"), "w") as f:
            # store the step dir NAME, not an absolute path — the checkpoint
            # directory must stay relocatable (loaders join it with
            # `directory`) — plus the net width, so loaders don't need the
            # TrainConfig
            bc = int(state.params["Conv_0"]["kernel"].shape[-1])
            json.dump({"step": step, "path": os.path.basename(path),
                       "base_channels": bc}, f)
    return path


def load_checkpoint(directory: str, config: Optional[TrainConfig] = None,
                    path: Optional[str] = None):
    """Returns (model, variables) restored from a checkpoint dir."""
    config = config or TrainConfig()
    if path is None:
        with open(os.path.join(directory, "latest.json")) as f:
            latest = json.load(f)
        path = latest["path"]
        # the record stores the net width since round 3; honor it so
        # callers need not know the training config (legacy records
        # without it fall back to config.base_channels)
        if "base_channels" in latest:
            config = replace(config, base_channels=int(latest["base_channels"]))
        # legacy records stored absolute paths; new ones store the step dir
        # name relative to `directory` (relocatable checkouts)
        if not os.path.isabs(path):
            path = os.path.join(directory, path)
        elif not os.path.exists(path):
            path = os.path.join(directory, os.path.basename(path))
    restored = load_npz(path)
    model, _ = init_model(jax.random.PRNGKey(0), (8, 8), config.base_channels)
    return model, {"params": restored["params"],
                   "batch_stats": restored["batch_stats"]}


def train(config: TrainConfig) -> Dict[str, Any]:
    """Run the training loop; returns summary dict (best PSNR etc.)."""
    state = create_state(config)
    os.makedirs(config.checkpoint_dir, exist_ok=True)

    if config.skip_training:
        path = save_checkpoint(state, config.checkpoint_dir, 0)
        return {"best_psnr": 0.0, "epochs_run": 0, "checkpoint": path}

    dataset = TripletDataset(config.source, config.resolution)
    train_idx, val_idx = dataset.split(config.val_fraction, config.seed)
    jit_train = jax.jit(train_step)
    jit_eval = jax.jit(eval_step)

    log_f = open(config.log_path, "a") if config.log_path else None
    best_psnr = -1.0
    best_path = None
    patience = 0
    rng = np.random.default_rng(config.seed)
    epochs_run = 0

    for epoch in range(config.epochs):
        epochs_run = epoch + 1
        t0 = time.time()
        order = rng.permutation(train_idx)
        losses = []
        for inputs, targets in dataset.batches(order, config.batch_size):
            state, loss, _ = jit_train(state, jnp.asarray(inputs), jnp.asarray(targets))
            losses.append(float(loss))

        val_l1, val_psnr, val_ssim = [], [], []
        for inputs, targets in dataset.batches(val_idx, config.batch_size):
            l1, p, s = jit_eval(state, jnp.asarray(inputs), jnp.asarray(targets))
            val_l1.append(float(l1)); val_psnr.append(float(p)); val_ssim.append(float(s))

        record = {
            "epoch": epoch, "train_l1": float(np.mean(losses)),
            "val_l1": float(np.mean(val_l1)), "val_psnr": float(np.mean(val_psnr)),
            "val_ssim": float(np.mean(val_ssim)), "seconds": time.time() - t0,
        }
        logger.info("epoch %d: %s", epoch, json.dumps(record))
        if log_f:
            log_f.write(json.dumps(record) + "\n")
            log_f.flush()

        if record["val_psnr"] > best_psnr:
            best_psnr = record["val_psnr"]
            best_path = save_checkpoint(state, config.checkpoint_dir, epoch)
            patience = 0
        else:
            patience += 1
            if patience >= config.early_stop_patience:
                logger.info("early stop at epoch %d (best PSNR %.2f)", epoch, best_psnr)
                break
        if config.checkpoint_every and (epoch + 1) % config.checkpoint_every == 0:
            # resume snapshot only: latest.json keeps pointing at the BEST
            save_checkpoint(state, config.checkpoint_dir, epoch,
                            update_latest=False)

    if log_f:
        log_f.close()
    return {"best_psnr": best_psnr, "epochs_run": epochs_run, "checkpoint": best_path}
