#!/usr/bin/env python
"""Train the 2× super-resolution net (ai/upscaler.py) on procedurally
generated render pairs — no dataset needed: the renderer IS the data
generator, and both run on the same chip.

Each sample renders one random scene twice with the same camera: the
target at full resolution and the input at half resolution (a real
half-res render, aliasing and all — exactly what the ai_upscale mode
feeds the net at runtime). Reports PSNR vs the bilinear baseline on a
held-out set and saves an .npz checkpoint.

    python scripts/train_upscaler.py --pairs 192 --steps 1500 \
        --out assets_out/upscaler_2x
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import jax
import jax.numpy as jnp
import optax


def build_pool(res: int, seed: int, *, shadows: bool = True, grid: int = 6,
               spread: float = 4.5, scale_range=(0.4, 1.4)):
    """One scene topology (retrace-free across samples); randomness lives
    in transforms/camera/lights/texture assignment. Pools differ in the
    STATIC axes a single renderer can't vary without retracing: shadow
    pass on/off and entity count (geometry density). Training across
    several pools is what keeps the net usable out of distribution — the
    round-2 spatial checkpoint, trained on one shadowed 6x6 pool, scored
    ~1 dB BELOW bilinear on an unshadowed single-cube scene."""
    from trident.core.config import EngineConfig, RenderConfig
    from trident.ecs.components import (
        LightComponent, LightType, MeshComponent, TextureComponent,
        TransformComponent)
    from trident.ecs.registry import Registry
    from trident.geometry.primitives import PrimitiveType
    from trident.io.image import checkerboard
    from trident.render.renderer import Renderer

    rng = np.random.default_rng(seed)
    r = Renderer(EngineConfig(render=RenderConfig(
        width=res, height=res, shadows=shadows, shadow_map_size=256)))
    reg = Registry()
    r.set_active_registry(reg)
    # texture pool: checkers at several frequencies + hue noise
    for i in range(6):
        if i < 3:
            img = checkerboard(128, 4 << i)
        else:
            img = (rng.random((64, 64, 4)) * 255).astype(np.uint8)
            img[..., 3] = 255
        r.acquire_texture(f"t{i}", img)
    sphere = r.ensure_primitive(PrimitiveType.SPHERE)
    cube = r.ensure_primitive(PrimitiveType.CUBE)
    ents = []
    for i in range(grid):
        for j in range(grid):
            e = reg.create()
            reg.add(e, TransformComponent())
            reg.add(e, MeshComponent(
                mesh_index=sphere if (i + j) % 2 else cube))
            reg.add(e, TextureComponent(path="t0", slot=1))
            ents.append(e)
    sun = reg.create()
    reg.add(sun, TransformComponent())
    reg.add(sun, LightComponent(light_type=LightType.DIRECTIONAL,
                                cast_shadows=shadows))
    return r, reg, ents, sun, rng, (spread, scale_range)


# the three static-axis pools samples round-robin across: the shadowed
# medium grid (editor scenes), a dense unshadowed grid (the 1M-sphere
# bench character: many small high-frequency silhouettes), and a sparse
# unshadowed closeup (cube512 / single-object scenes)
POOL_SPECS = (
    dict(shadows=True, grid=6, spread=4.5, scale_range=(0.4, 1.4)),
    dict(shadows=False, grid=10, spread=5.5, scale_range=(0.25, 0.7)),
    dict(shadows=False, grid=2, spread=2.0, scale_range=(0.8, 1.8)),
)


def randomize(r, reg, ents, sun, rng, spread=4.5, scale_range=(0.4, 1.4)):
    from trident.ecs.components import (
        LightComponent, TextureComponent, TransformComponent)

    for e in ents:
        t = reg.get(e, TransformComponent)
        t.position = rng.uniform(-spread, spread, 3).astype(np.float32)
        t.rotation = rng.uniform(0, 360, 3).astype(np.float32)
        t.scale = np.full(3, rng.uniform(*scale_range), np.float32)
        reg.get(e, TextureComponent).slot = int(rng.integers(1, 7))
    lc = reg.get(sun, LightComponent)
    d = rng.normal(size=3)
    d[1] = -abs(d[1]) - 0.3
    lc.direction = (d / np.linalg.norm(d)).astype(np.float32)
    lc.intensity = float(rng.uniform(2.0, 5.0))
    ang = rng.uniform(0, 2 * np.pi)
    dist = rng.uniform(6.0, 11.0)
    r.editor_camera.set_position([np.sin(ang) * dist,
                                  rng.uniform(0.5, 4.0),
                                  np.cos(ang) * dist])
    tgt = rng.uniform(-1, 1, 3)
    r.editor_camera.look_at_target(tgt)
    return tgt


def render_sequence_pairs(n_pairs: int, res: int, seed: int,
                          with_depth: bool = False):
    """Temporal mode: per sample, render the PREVIOUS frame at full res
    from a nearby camera, then orbit a little and render the current
    half-res input + full-res target + half-res depth + both cameras'
    view-projections. The warp input is built with the SAME
    warp_previous the runtime uses, so train == inference."""
    from trident.ai.upscaler import warp_previous

    pools = [build_pool(res, seed + i, **spec)
             for i, spec in enumerate(POOL_SPECS)]
    xs, depths, temporals, targets = [], [], [], []
    t0 = time.time()
    warp_j = jax.jit(warp_previous, static_argnames=("full_width",
                                                     "full_height"))
    for k in range(n_pairs):
        r, reg, ents, sun, rng, (spread, srange) = pools[k % len(pools)]
        tgt = randomize(r, reg, ents, sun, rng, spread, srange)
        cam = r.editor_camera
        # previous frame: full res at pose A
        r.set_viewport(0, res, res)
        prev_out = r.render_viewport(0)
        prev_rgb = np.asarray(prev_out.color)[..., :3].astype(np.float32) / 255.0
        pa = cam.params()
        prev_vp = np.asarray(pa.proj) @ np.asarray(pa.view)
        # frame-to-frame motion: mostly camera (orbit + dolly jitter), but
        # a fraction rotates the OBJECTS under a static camera — the warp
        # is then an identity map with stale content, the history-mismatch
        # case animated scenes hit at runtime
        if rng.random() < 0.3:
            from trident.ecs.components import TransformComponent

            for e in ents:
                t = reg.get(e, TransformComponent)
                t.rotation = t.rotation + rng.uniform(-6, 6, 3).astype(
                    np.float32)
        else:
            cam.orbit(tgt, float(rng.uniform(-4, 4)),
                      float(rng.uniform(-2, 2)))
            cam.dolly(float(rng.uniform(-0.3, 0.3)))
        targets.append(np.asarray(r.read_frame())[..., :3])
        r.set_viewport(0, res // 2, res // 2)
        cur_out = r.render_viewport(0)
        xs.append(np.asarray(cur_out.color)[..., :3].astype(np.float32) / 255.0)
        if with_depth:
            depths.append(np.asarray(cur_out.depth)[..., None]
                          .astype(np.float32))
        pb = cam.params()
        vp = np.asarray(pb.proj) @ np.asarray(pb.view)
        t_in = np.asarray(warp_j(
            jnp.asarray(prev_rgb), jnp.asarray(np.asarray(cur_out.depth)),
            jnp.asarray(np.linalg.inv(vp).astype(np.float32)),
            jnp.asarray(prev_vp.astype(np.float32)),
            full_width=res, full_height=res))
        # a fraction trains with NO history (valid=0 → the first-frame /
        # spatial-fallback case the runtime hits after scene edits)
        if rng.random() < 0.2:
            t_in = np.zeros_like(t_in)
        temporals.append(t_in)
        if (k + 1) % 32 == 0:
            print(f"  rendered {k + 1}/{n_pairs} sequence pairs "
                  f"({time.time() - t0:.0f}s)", flush=True)
    x = np.stack(xs).astype(np.float32)
    t = np.stack(temporals).astype(np.float32)
    parts = [x] + ([np.stack(depths)] if with_depth else []) + [t]
    return (np.concatenate(parts, axis=-1),
            np.stack(targets).astype(np.float32) / 255.0)


def render_pairs(n_pairs: int, res: int, seed: int,
                 with_depth: bool = False):
    """→ (inputs (N,res/2,res/2,3|4), targets (N,res,res,3)) float32."""
    pools = [build_pool(res, seed + i, **spec)
             for i, spec in enumerate(POOL_SPECS)]
    inputs, targets = [], []
    t0 = time.time()
    for k in range(n_pairs):
        r, reg, ents, sun, rng, (spread, srange) = pools[k % len(pools)]
        randomize(r, reg, ents, sun, rng, spread, srange)
        r.set_viewport(0, res, res)
        targets.append(np.asarray(r.read_frame())[..., :3])
        r.set_viewport(0, res // 2, res // 2)
        cur_out = r.render_viewport(0)
        rgb = np.asarray(cur_out.color)[..., :3].astype(np.float32) / 255.0
        if with_depth:
            rgb = np.concatenate(
                [rgb, np.asarray(cur_out.depth)[..., None]
                 .astype(np.float32)], axis=-1)
        inputs.append(rgb)
        if (k + 1) % 32 == 0:
            print(f"  rendered {k + 1}/{n_pairs} pairs "
                  f"({time.time() - t0:.0f}s)", flush=True)
    return (np.stack(inputs).astype(np.float32),
            np.stack(targets).astype(np.float32) / 255.0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=192,
                    help="total rendered pairs (split across --res scales)")
    ap.add_argument("--res", type=str, default="256",
                    help="render resolution(s), comma-separated (e.g. "
                         "'256,128'): multi-scale training fixes the "
                         "out-of-distribution regression at scales the net "
                         "never saw (the conv net itself is size-agnostic; "
                         "batches stay uniform per step, alternating scales)")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--edge-weight", type=float, default=0.25,
                    help="extra L1 on image gradients (sharpens edges)")
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temporal", action="store_true",
                    help="train the temporal net: previous full-res frame "
                         "reprojected by depth rides in as 13 extra "
                         "channels (ai/upscaler.py warp_previous)")
    ap.add_argument("--depth", action="store_true",
                    help="feed the half-res G-buffer depth as an extra "
                         "input channel (silhouette edges are unambiguous "
                         "where rgb alone aliases); composes with "
                         "--temporal")
    ap.add_argument("--out", default="assets_out/upscaler_2x")
    ap.add_argument("--init-from", default=None,
                    help="resume/fine-tune from an existing checkpoint dir "
                         "(channel layout must match the selected flags); "
                         "dataset rendering is the expensive phase, so "
                         "continuing a run costs little extra")
    args = ap.parse_args()

    from trident.ai.upscaler import (
        UpscalerNet, init_upscaler, load_upscaler, psnr, save_upscaler)

    res_list = [int(r) for r in str(args.res).split(",") if r]
    per_res = max(args.pairs // len(res_list), 8)
    datasets = []   # one (tr_in, tr_tg, val_in, val_tg, res) per scale
    for j, res in enumerate(res_list):
        print(f"rendering training pairs at {res}px…", flush=True)
        if args.temporal:
            inputs, targets = render_sequence_pairs(
                per_res, res, args.seed + 101 * j, with_depth=args.depth)
        else:
            inputs, targets = render_pairs(
                per_res, res, args.seed + 101 * j, with_depth=args.depth)
        n_val = max(per_res // 8, 4)
        datasets.append((inputs[n_val:], targets[n_val:],
                         inputs[:n_val], targets[:n_val], res))
    tr_in, tr_tg, val_in, val_tg, _ = datasets[0]
    inputs = datasets[0][0]

    model = UpscalerNet(base_channels=args.channels)
    if args.init_from:
        from trident.ai.upscaler import upscaler_in_channels

        params, bc = load_upscaler(args.init_from)
        if bc != args.channels or (upscaler_in_channels(params)
                                   != inputs.shape[-1]):
            raise SystemExit(
                f"--init-from {args.init_from}: checkpoint is "
                f"{bc}ch/{upscaler_in_channels(params)}-input but the run "
                f"wants {args.channels}ch/{inputs.shape[-1]}-input")
        print(f"resuming from {args.init_from}", flush=True)
    else:
        _, variables = init_upscaler(jax.random.PRNGKey(args.seed),
                                     args.channels,
                                     in_channels=inputs.shape[-1])
        params = variables["params"]
    schedule = optax.cosine_decay_schedule(args.lr, args.steps, 0.02)
    tx = optax.adam(schedule)
    opt_state = tx.init(params)
    ew = args.edge_weight

    @jax.jit
    def step(params, opt_state, x, y):
        def loss_fn(p):
            out = model.apply({"params": p}, x)
            l1 = jnp.mean(jnp.abs(out - y))
            # gradient (edge) term: penalize blurred detail specifically
            gx = jnp.mean(jnp.abs((out[:, :, 1:] - out[:, :, :-1])
                                  - (y[:, :, 1:] - y[:, :, :-1])))
            gy = jnp.mean(jnp.abs((out[:, 1:] - out[:, :-1])
                                  - (y[:, 1:] - y[:, :-1])))
            return l1 + ew * (gx + gy)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    @jax.jit
    def evaluate(params, x, y):
        out = model.apply({"params": params}, x)
        base = jax.image.resize(x[..., :3], y.shape, "bilinear")
        return psnr(out, y), psnr(base, y)

    def eval_all(params):
        """Mean net/bilinear PSNR across every scale's val split (each
        scale compiles its own evaluate once)."""
        nets, bases = [], []
        for tr_i, tr_t, v_i, v_t, _res in datasets:
            n, b = evaluate(params, jnp.asarray(v_i), jnp.asarray(v_t))
            nets.append(float(n))
            bases.append(float(b))
        return (sum(nets) / len(nets), sum(bases) / len(bases),
                ["%d:%.2f" % (d[4], n) for d, n in zip(datasets, nets)])

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    best = -1.0
    for s in range(args.steps):
        # alternate scales per step: batches stay uniform (one jitted
        # step per scale), the NET trains across all of them
        tr_i, tr_t = datasets[s % len(datasets)][:2]
        idx = rng.integers(0, tr_i.shape[0], args.batch)
        params, opt_state, loss = step(params, opt_state,
                                       jnp.asarray(tr_i[idx]),
                                       jnp.asarray(tr_t[idx]))
        if (s + 1) % 100 == 0:
            net_p, base_p, per_res = eval_all(params)
            # checkpoint the best-so-far at every eval: a wall-clock kill
            # (driver timeout) then costs nothing — the plateau checkpoint
            # is already on disk
            mark = ""
            if net_p > best:
                best = net_p
                save_upscaler(jax.device_get(params), args.out)
                mark = " [saved]"
            detail = (" [" + " ".join(per_res) + "]"
                      if len(per_res) > 1 else "")
            print(f"step {s + 1}: L1={float(loss):.4f} "
                  f"val PSNR net={net_p:.2f}dB "
                  f"bilinear={base_p:.2f}dB{detail} "
                  f"({time.time() - t0:.0f}s){mark}", flush=True)

    net_p, base_p, _ = eval_all(params)
    if net_p > best:
        save_upscaler(jax.device_get(params), args.out)
    print(f"saved {args.out}: best val PSNR {max(best, net_p):.2f}dB "
          f"vs bilinear={base_p:.2f}dB")


if __name__ == "__main__":
    main()
