#!/usr/bin/env python
"""Benchmark: frames/s through the full render pipeline on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.
The north-star bar is 60 FPS at 1080p on a 1M-triangle scene on one
NVIDIA H100 (BASELINE.md), so vs_baseline is FPS/60. Every line names the
device it ran on (platform, kind, count, power limit); a platform other
than the GPU is refused — a CPU number is not a device number.

Two end-to-end numbers per config:
  * value: frames/s with all frames inside ONE jit (lax.scan over
    per-frame params) — device throughput, no per-frame dispatch;
  * extra.interactive_ms_p50 / p90: per-frame latency of the bundled
    interactive path (render/bundle.py — two host uploads per frame,
    what Renderer.render_viewport pays), each frame awaited.

Config via BENCH_CONFIG env: "spheres1080_1m" (default — the flagship
1M-triangle/1080p config the 60-FPS bar is defined on), "cube512",
"spheres1080" (~110k tris), "ultra4k" (1M tris @ 3840×2160 with bloom),
"shadows1080" (shadow pass) or "interp" (frame-interpolation net).
BENCH_AI=1 measures the half-res render + neural 2× reconstruction.
scripts/bench_sweep.py runs several configs in one process.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np

CONFIGS = {"cube512": 0, "spheres1080": 12, "spheres1080_1m": 36,
           "ultra4k": 36, "shadows1080": 12}
SCAN_REPEATS = 5
# bench_interp's PSNR vs the middle frame with the shipped checkpoint, as
# the flax implementation these nets were ported from computed it (CPU,
# float32); the plain-JAX net must reproduce it
INTERP_PSNR_DB = 14.412


def power_limit() -> str:
    """`name, power.limit` of the first card as nvidia-smi reports it
    ("not measured" where nvidia-smi is absent)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "not measured"
    return out.strip().splitlines()[0] if out.strip() else "not measured"


def device_info() -> dict:
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d), "nvidia_smi": power_limit()}


def require_gpu() -> dict:
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(f"bench refuses platform {info['platform']!r}: "
                         "measurements come from a GPU only")
    return info


def build_scene(config: str, ai: bool = False, bands: int = 1):
    from trident.core.config import EngineConfig, RenderConfig
    from trident.ecs.components import (
        MeshComponent, TextureComponent, TransformComponent,
    )
    from trident.ecs.registry import Registry
    from trident.geometry.primitives import PrimitiveType
    from trident.io.image import checkerboard
    from trident.render.renderer import Renderer

    if config not in CONFIGS:
        # a typo'd BENCH_CONFIG must fail loudly, not silently bench the
        # cube512 scene under a plausible-looking metric name
        raise SystemExit(f"unknown BENCH_CONFIG {config!r}; "
                         f"expected one of {sorted(CONFIGS)} (plus ':ai')")
    grid = CONFIGS[config]
    if config == "ultra4k":
        w, h = 3840, 2160
    else:
        w, h = (1920, 1080) if grid else (512, 512)

    cfg = EngineConfig(render=RenderConfig(
        width=w, height=h, bloom=(config == "ultra4k"),
        shadows=(config == "shadows1080"), ai_upscale=ai, bands=bands))
    r = Renderer(cfg)
    reg = Registry()
    r.set_active_registry(reg)
    slot = r.acquire_texture("checker", checkerboard(128, 8))

    if grid:
        mesh_idx = r.ensure_primitive(PrimitiveType.SPHERE)
        for i in range(grid):
            for j in range(grid):
                e = reg.create()
                t = reg.add(e, TransformComponent())
                t.position = np.array(
                    [(i - grid / 2) * 1.4, (j - grid / 2) * 1.4, 0], np.float32)
                reg.add(e, MeshComponent(mesh_index=mesh_idx))
                reg.add(e, TextureComponent(path="checker", slot=slot))
        r.editor_camera.set_position([0, 0, grid * 1.1 + 2])
        if config == "shadows1080":
            # BASELINE config 3: multi-object + mipmaps + shadow pass. A
            # backdrop behind the sphere grid receives the cast shadows;
            # an angled sun with cast_shadows triggers the two-pass render
            # graph (depth-only light pass + shadow lookup in shading).
            from trident.ecs.components import LightComponent
            backdrop = reg.create()
            bt = reg.add(backdrop, TransformComponent())
            bt.position = np.array([0.0, 0.0, -2.0], np.float32)
            bt.scale = np.array([grid * 1.4, grid * 1.4, 0.2], np.float32)
            cube_idx = r.ensure_primitive(PrimitiveType.CUBE)
            reg.add(backdrop, MeshComponent(mesh_index=cube_idx))
            reg.add(backdrop, TextureComponent(path="checker", slot=slot))
            sun = reg.create()
            reg.add(sun, TransformComponent())
            reg.add(sun, LightComponent(
                direction=np.array([0.35, -0.3, -1.0], np.float32),
                intensity=2.5, cast_shadows=True))
    else:
        mesh_idx = r.ensure_primitive(PrimitiveType.CUBE)
        e = reg.create()
        reg.add(e, TransformComponent())
        reg.add(e, MeshComponent(mesh_index=mesh_idx))
        reg.add(e, TextureComponent(path="checker", slot=slot))
        r.editor_camera.set_position([0, 0, 3])
    r.editor_camera.look_at_target([0, 0, 0])
    return r, reg, (w, h)


def bench_interp(iters: int = 30, train_steps: int = 0) -> dict:
    """BASELINE.json config 4: the frame-interpolation U-Net at the
    reference's 256×256 net resolution, on a synthetic moving pattern.
    Reports inference ms/frame; vs_baseline is the reference's 66 ms
    inference/readback throttle (Renderer.h:522) divided by it.
    `train_steps` > 0 also runs that many ai/train.py optimizer steps on
    synthetic triplets and reports their losses."""
    import jax
    import jax.numpy as jnp

    from trident.ai.metrics import psnr
    from trident.ai.train import load_checkpoint

    ckpt = os.environ.get("BENCH_INTERP_CKPT", "assets_out/frame_generator_128")
    model, variables = load_checkpoint(ckpt)
    res = 256
    base = jnp.linspace(0, 1, res)[:, None, None] * jnp.ones((1, res, 3))
    frames = [jnp.roll(base, 8 * k, axis=1) for k in range(3)]
    pair = jnp.concatenate([frames[0], frames[2]], axis=-1)[None]

    infer = jax.jit(lambda x: model.apply(variables, x, train=False))
    out = jax.block_until_ready(infer(pair))            # compile + first run
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(infer(pair))
        times.append(time.perf_counter() - t0)
    ms = float(np.median(times)) * 1000.0
    result = {"metric": f"interp_infer_{res}", "value": ms,
              "unit": "ms/frame", "vs_baseline": 66.0 / max(ms, 1e-6),
              "extra": {"psnr_db_vs_middle_frame":
                        float(psnr(out, frames[1][None])),
                        "finite": bool(np.isfinite(np.asarray(out)).all()),
                        "iters": iters, "checkpoint": ckpt}}
    if train_steps:
        from trident.ai.train import TrainConfig, create_state, train_step

        state = create_state(TrainConfig(resolution=(res, res),
                                         base_channels=16, batch_size=2))
        step = jax.jit(train_step)
        inputs = jnp.concatenate([pair, pair], axis=0)
        targets = jnp.concatenate([frames[1][None]] * 2, axis=0)
        losses = []
        for _ in range(train_steps):
            state, loss, _ = step(state, inputs, targets)
            losses.append(float(loss))
        result["extra"]["train_losses"] = losses
    return result


def run_config(config: str, iters: int = 30, use_ai: bool = False) -> dict:
    """Measure one config; returns the JSON-able result dict. The scan of
    `iters` frames is timed SCAN_REPEATS times; `value` is the median."""
    import jax
    import jax.numpy as jnp
    from trident.ecs.components import (
        LightComponent, LightType, TransformComponent,
    )
    from trident.render.bundle import pack_frame
    from trident.render.frame import (
        build_draw_params, gather_mesh_draws, geometry_to_device,
    )
    from trident.render.lights import gather_lights
    from trident.render.renderer import render_frame, render_frame_bundled
    from trident.render.types import AiBlend, CameraParams, SkyboxCube

    upscale_params = None
    if use_ai:
        from trident.ai import upscaler as up

        upscale_params, _bc = up.load_upscaler(
            os.environ.get("BENCH_AI_CKPT", "assets_out/upscaler_2x"))
        upscale_params = jax.device_put(upscale_params)

    renderer, registry, (w, h) = build_scene(config)
    entities = [e for e, _ in registry.view(TransformComponent)]

    # per-frame draw params for distinct rotations, built before timing
    packed = renderer.geometry.packed()
    geo = geometry_to_device(packed)
    plans = []
    for k in range(iters):
        angle = 25.0 + k * 3.0
        for e in entities:
            registry.get(e, TransformComponent).rotation = np.array(
                [angle * 0.4, angle, 0.0], np.float32)
        records = gather_mesh_draws(registry, renderer.geometry)
        plan, tri_draw = renderer._plan_cache.plan(packed, records,
                                                   renderer.geometry.version)
        params, palette, shade = build_draw_params(
            records, plan.num_draws,
            material_table=renderer.geometry.material_table())
        plans.append((plan, tri_draw, params, palette, shade))
    n_tris = sum(packed.draw_infos[r_.mesh_index].index_count // 3
                 for r_ in gather_mesh_draws(registry, renderer.geometry))
    lights = gather_lights(registry)
    # shadow pass: mirror Renderer.render_viewport's light-camera setup
    shadow_size = 0
    light_cam = None
    for _e, (lc,) in registry.view(LightComponent):
        if (lc.enabled and lc.light_type == LightType.DIRECTIONAL
                and lc.cast_shadows):
            from trident.ops.shadow import light_camera, scene_bounds
            center, radius = scene_bounds(
                gather_mesh_draws(registry, renderer.geometry), packed)
            light_cam = light_camera(lc.direction, center, radius)
            shadow_size = renderer.config.render.shadow_map_size
            break
    tex = renderer.textures.device_arrays()
    cam = renderer.editor_camera.params()
    sky = SkyboxCube(faces=jnp.zeros((6, 1, 1, 3), jnp.float32),
                     valid=jnp.asarray(False))
    ai = AiBlend(image=jnp.zeros((1, 1, 3), jnp.float32),
                 blend=jnp.asarray(0.0, jnp.float32))
    raster = renderer._raster_mode()
    corner_t = renderer._plan_cache.corner_table(packed)
    rw, rh = (w // 2, h // 2) if use_ai else (w, h)

    # temporal upscaler: chain each frame's history + view-projection into
    # the next call (the renderer's ViewportContext.prev_state analogue)
    temporal_ai = False
    hist0 = None
    if upscale_params is not None:
        temporal_ai = up.upscaler_wants_temporal(upscale_params)
        hist0 = (jnp.zeros((rh, rw, 12), jnp.uint8) if up.V2
                 else jnp.zeros((h, w, 4), jnp.uint8))
    vp_mat = jnp.asarray(np.asarray(cam.proj) @ np.asarray(cam.view))

    def _hist_of(o):
        return o.history if o.history is not None else o.color

    stride_kw = renderer._stride_kwargs(skinned=False)
    statics = dict(width=rw, height=rh,
                   clear_color=tuple(renderer.config.render.clear_color),
                   raster=raster, chunk=64, skinned=False,
                   shadow_size=shadow_size,
                   bloom=renderer.config.render.bloom, **stride_kw)

    def frame(plan, tri_draw, params, palette, shade, prev=None, **kw):
        return render_frame(
            geo, plan, tri_draw, params, palette, shade, cam, lights, tex,
            sky, ai, light_camera=light_cam, corner_t=corner_t,
            **{"upscale_params": upscale_params, "prev": prev, **statics,
               **kw})

    def check_aux(aux, where: str) -> list:
        """Fail on raster capacity overflow: a silently truncating bench
        would report inflated FPS on missing geometry."""
        a = np.asarray(aux).reshape(-1, 2).sum(axis=0)
        if a[0] or a[1]:
            raise SystemExit(
                f"bench invalid ({where}): raster overflow — {int(a[0])} "
                f"pairs truncated, {int(a[1])} big chunks dropped; the "
                "rendered geometry is incomplete")
        return [int(a[0]), int(a[1])]

    t0 = time.perf_counter()
    out = jax.block_until_ready(frame(*plans[0]))
    compile_s = {"render_frame": time.perf_counter() - t0}
    aux_counts = check_aux(out.aux, "first frame")
    finite = bool(np.isfinite(np.asarray(out.depth)).all())

    # interactive path: one dispatch per frame through the bundled call
    plan0, tri_draw0, _, palette0, shade0 = plans[0]
    bundles = []
    for _plan, _td, p_, pal_, sh_ in plans:
        f32b, i32b, shape = pack_frame(p_, np.asarray(pal_), np.asarray(sh_),
                                       cam, lights, light_cam, 0.0)
        bundles.append((f32b, i32b))
    ai_img = jnp.zeros((1, 1, 3), jnp.float32)
    frame_b = jax.jit(lambda f32b, i32b, prev: render_frame_bundled(
        geo, plan0, tri_draw0, f32b, i32b, tex, sky, ai_img, corner_t,
        upscale_params, prev, shape=shape, **statics))
    prev = (hist0, vp_mat) if temporal_ai else None
    t0 = time.perf_counter()
    out = jax.block_until_ready(frame_b(*bundles[0], prev))
    compile_s["render_frame_bundled"] = time.perf_counter() - t0
    check_aux(out.aux, "bundled frame")
    finite &= bool(np.isfinite(np.asarray(out.depth)).all())
    lat = []
    for k in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(frame_b(*bundles[k], prev))
        lat.append(time.perf_counter() - t0)
        if temporal_ai:
            prev = (_hist_of(out), vp_mat)

    # device throughput: all frames inside ONE jit via lax.scan
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[2] for p in plans])

    def scan_bench(params_seq):
        def body(prev, params_k):
            o = frame(plan0, tri_draw0, params_k, palette0, shade0, prev)
            aux = jnp.asarray(o.aux).reshape(-1, 2).sum(axis=0)
            new_prev = (_hist_of(o), vp_mat) if temporal_ai else None
            return new_prev, (o.color[0, 0, 0], aux,
                              jnp.isfinite(o.depth).all())
        init = (hist0, vp_mat) if temporal_ai else None
        _, (samples, aux, fin) = jax.lax.scan(body, init, params_seq)
        return samples, aux.sum(axis=0), fin.all()

    scan_jit = jax.jit(scan_bench)
    t0 = time.perf_counter()
    _, aux_all, fin = jax.block_until_ready(scan_jit(stacked))
    compile_s["scan"] = time.perf_counter() - t0
    check_aux(aux_all, f"scan over all {iters} frames")
    finite &= bool(fin)
    scan_runs = []
    for _ in range(SCAN_REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(scan_jit(stacked))
        scan_runs.append(iters / (time.perf_counter() - t0))
    scan_fps = float(np.median(scan_runs))

    extra_quality = {}
    if use_ai:
        # PSNR on frame 1 of the rotation sequence vs the native render; a
        # temporal net first reconstructs frame 0 (prev=None → its
        # zero-validity spatial fallback) and consumes it as history
        native = frame(*plans[1], upscale_params=None, width=w, height=h)
        check_aux(native.aux, f"native {w}x{h} PSNR oracle frame")
        prev_eval = None
        if temporal_ai:
            prev_eval = (_hist_of(frame(*plans[0])), vp_mat)
        recon = frame(*plans[1], prev=prev_eval)
        a = np.asarray(native.color[..., :3]).astype(np.float32) / 255.0
        b = np.asarray(recon.color[..., :3]).astype(np.float32) / 255.0
        mse = float(np.mean(np.square(a - b)))
        extra_quality["psnr_vs_native_db"] = -10.0 * np.log10(max(mse, 1e-10))

    return {
        "metric": f"render_fps_{config}{'_ai' if use_ai else ''}_{w}x{h}",
        "value": scan_fps, "unit": "frames/s",
        "vs_baseline": scan_fps / 60.0,
        "extra": {"triangles": int(n_tris),
                  "interactive_ms_p50": float(np.median(lat)) * 1e3,
                  "interactive_ms_p90": float(np.percentile(lat, 90)) * 1e3,
                  "compile_s": compile_s, "raster": raster,
                  "aux": aux_counts, "finite": finite, "iters": iters,
                  "scan_fps_runs": scan_runs, **extra_quality}}


def main() -> None:
    info = require_gpu()
    config = os.environ.get("BENCH_CONFIG", "spheres1080_1m")
    iters = int(os.environ.get("BENCH_ITERS", "30"))
    if config == "interp":
        result = bench_interp(iters)
    else:
        result = run_config(
            config, iters, use_ai=os.environ.get("BENCH_AI", "") not in
            ("", "0"))
    result["extra"]["device"] = info
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    from trident.core.platform import compile_cache_dir

    compile_cache_dir()
    main()
