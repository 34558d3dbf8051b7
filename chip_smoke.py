#!/usr/bin/env python
"""Smoke test of the renderer on one NVIDIA GPU, through its entry points.

    python chip_smoke.py            # one card: phases (a)-(e)
    python chip_smoke.py --four     # four cards: banded ultra4k vs one card

Phases (any failure ends the run with a non-zero exit code):
  (a) the platform is "gpu": card name and power limit, JAX device kind
      and count, and which optional packages are installed (probed in a
      child that never imports JAX);
  (b) the `gpu`-marked tests, in a child process, before this process
      touches the card (one JAX process per card at a time);
  (c) the Triton visibility kernel compiled at the flagship's real widths
      (1M triangles, 1920×1080): memory analysis, then three 32-row bands
      of its frame against the reference oracle;
  (d) every main path rendered a few frames, with aux == [0, 0] and
      finite output: spheres1080_1m, shadows1080, ultra4k and
      spheres1080_1m:ai through Renderer.render_viewport and bench.py's
      render_frame / render_frame_bundled / scan loop; the frame-
      interpolation net, its PSNR on bench_interp's input checked against
      bench.INTERP_PSNR_DB, plus 3 training steps (interp);
  (e) informational: scan FPS (median and spread of several scans) and
      interactive latency at spheres1080_1m.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG_PROBE = """
import importlib
for m in ("flax", "orbax.checkpoint", "PIL", "imageio"):
    try:
        mod = importlib.import_module(m)
    except ImportError as exc:
        print(f"  {m}: missing ({type(exc).__name__})")
    else:
        print(f"  {m}: {getattr(mod, '__version__', 'present')}")
"""
PLATFORM_PROBE = "import jax; print(jax.devices()[0].platform)"


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _child(args, timeout: float) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, *args], cwd=ROOT, timeout=timeout,
                          capture_output=True, text=True)


def phase_a() -> str:
    """Card, packages and platform; returns the nvidia-smi line."""
    check(os.path.isdir(os.path.join(ROOT, "trident")),
          f"no trident package beside {__file__}")
    smi = "not measured"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        raise SmokeFailure(f"nvidia-smi failed: {exc}") from exc
    log(f"(a) card: {smi}")
    log("(a) optional packages:")
    pkgs = _child(["-c", PKG_PROBE], 120)
    log((pkgs.stdout + pkgs.stderr[-1000:]).rstrip())
    probe = _child(["-c", PLATFORM_PROBE], 300)
    platform = probe.stdout.strip().splitlines()[-1] if probe.stdout else ""
    check(probe.returncode == 0 and platform == "gpu",
          f"JAX platform is {platform or probe.stderr[-400:]!r}, not gpu")
    return smi


def phase_b() -> None:
    t0 = time.perf_counter()
    res = _child(["-m", "pytest", "tests/test_gpu.py", "-m", "gpu", "-q",
                  "-s", "-p", "no:cacheprovider", "-p", "no:xdist"], 900)
    lines = res.stdout.rstrip().splitlines()
    for line in lines:
        # -s output shares lines with pytest's progress characters
        line = line.lstrip(".sFE")
        if line.startswith(("flavor ", "110k parity", "cube512", "spheres",
                            "ultra4k", "shadows")):
            log(f"(b)   {line}")
    summary = lines[-1] if lines else res.stderr[-400:]
    log(f"(b) gpu tests: {summary} ({time.perf_counter() - t0:.1f} s)")
    check(res.returncode == 0 and "skipped" not in summary
          and "passed" in summary,
          f"gpu tests failed:\n{res.stdout[-3000:]}\n{res.stderr[-2000:]}")


def _flagship_setup(bench):
    """The flagship frame's triangle setup, exactly as the renderer's
    corner-major path builds it."""
    from trident.ops.corner import build_draw_rows, corner_stage
    from trident.render.frame import build_draw_params, gather_mesh_draws

    r, reg, (w, h) = bench.build_scene("spheres1080_1m")
    packed = r.geometry.packed()
    records = gather_mesh_draws(reg, r.geometry)
    plan, tri_draw = r._plan_cache.plan(packed, records, r.geometry.version)
    params, _, _ = build_draw_params(
        records, plan.num_draws, material_table=r.geometry.material_table())
    corner_t = r._plan_cache.corner_table(packed)
    rows = build_draw_rows(params, r.editor_camera.params(), w, h)
    setup = corner_stage(corner_t, rows, tri_draw, plan.tri_valid, w, h,
                         **r._stride_kwargs(False)).setup
    return setup, w, h


def phase_c(bench) -> None:
    import jax
    import numpy as np

    from trident.ops.raster import visibility
    from trident.ops.raster_ref import (
        unexplained_mismatches, visibility_ref)
    from trident.ops.vertex import band_slice_setup

    setup, w, h = _flagship_setup(bench)
    n_tri = int(setup.edge.shape[0])
    fn = jax.jit(lambda s: visibility(s, w, h, interpret=False))
    t0 = time.perf_counter()
    compiled = fn.lower(setup).compile()
    log(f"(c) visibility kernel compiled at {n_tri} triangles {w}x{h} in "
        f"{time.perf_counter() - t0:.1f} s: {compiled.memory_analysis()}")
    g = jax.block_until_ready(compiled(setup))
    times = []
    for _ in range(30):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(setup))
        times.append(time.perf_counter() - t0)
    log(f"(c) visibility (binning + kernel) at the flagship: median "
        f"{np.median(times) * 1e3:.3f} ms of 30 (min "
        f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}; informational)")
    aux = np.asarray(g.aux)
    check(aux.sum() == 0, f"flagship raster overflow {aux.tolist()}")
    pt, pd = np.asarray(g.tri_id), np.asarray(g.depth)
    ref = jax.jit(lambda s, y0: visibility_ref(
        band_slice_setup(s, y0, 32), w, 32, chunk=64, y_offset=y0))
    for y0 in (256, 512, 768):
        b = ref(setup, y0)
        rt, rd = np.asarray(b.tri_id), np.asarray(b.depth)
        kt, kd = pt[y0:y0 + 32], pd[y0:y0 + 32]
        mism = rt != kt
        bad = unexplained_mismatches(setup, rt, rd, kt, kd, y_offset=y0)
        covered = int((rt >= 0).sum())
        log(f"(c) flagship band y={y0}: {covered} covered px, "
            f"{int(mism.sum())} winner mismatches, {len(bad)} unexplained, "
            f"max |dd| where winners agree "
            f"{float(np.abs(rd[~mism] - kd[~mism]).max()):.3g}")
        check(covered > 0, f"band y={y0} is empty: the spot check sees no "
              "geometry")
        check(not bad and mism.sum() <= 200,
              f"band y={y0}: {int(mism.sum())} mismatches, e.g. {bad[:5]}")
        np.testing.assert_allclose(rd[~mism], kd[~mism], rtol=1e-6,
                                   atol=1e-7)


def _renderer_frames(bench, config: str, ai: bool, n: int = 3) -> None:
    """A few frames through Renderer.render_viewport (the entity rotates
    between frames so no frame is the idle-frame cache's)."""
    import numpy as np

    from trident.ecs.components import TransformComponent

    r, reg, _ = bench.build_scene(config, ai=ai)
    ents = [e for e, _ in reg.view(TransformComponent)]
    for k in range(n):
        for e in ents:
            reg.get(e, TransformComponent).rotation = np.array(
                [10.0 * k, 25.0 + 7.0 * k, 0.0], np.float32)
        out = r.render_viewport(r.active_viewport)
        aux = np.asarray(out.aux).reshape(-1, 2).sum(axis=0)
        color = np.asarray(out.color)
        check(aux.sum() == 0, f"{config}: aux {aux.tolist()}")
        check(bool(np.isfinite(np.asarray(out.depth)).all()),
              f"{config}: non-finite depth")
        check(color.shape[:2] == (r.viewports[0].height,
                                  r.viewports[0].width),
              f"{config}: frame shape {color.shape}")
    log(f"(d) {config}{':ai' if ai else ''} Renderer.render_viewport x{n}: "
        f"{color.shape}, aux [0, 0], mean {color[..., :3].mean():.2f}")


def phase_d(bench) -> dict:
    results = {}
    for config, ai, iters in (("spheres1080_1m", False, 30),
                              ("shadows1080", False, 3),
                              ("ultra4k", False, 3),
                              ("spheres1080_1m", True, 3)):
        _renderer_frames(bench, config, ai)
        t0 = time.perf_counter()
        res = bench.run_config(config, iters, use_ai=ai)
        ex = res["extra"]
        check(ex["aux"] == [0, 0] and ex["finite"],
              f"{config}: aux {ex['aux']} finite {ex['finite']}")
        log(f"(d) {res['metric']} via render_frame/bundled/scan x{iters}: "
            f"aux {ex['aux']}, finite, compile {ex['compile_s']}"
            + (f", PSNR vs native {ex['psnr_vs_native_db']:.2f} dB"
               if ai else "")
            + f" ({time.perf_counter() - t0:.1f} s)")
        results[res["metric"]] = res
    res = bench.bench_interp(iters=5, train_steps=3)
    losses = res["extra"]["train_losses"]
    import numpy as np

    psnr = res["extra"]["psnr_db_vs_middle_frame"]
    check(res["extra"]["finite"] and bool(np.isfinite(losses).all()),
          f"interp: finite {res['extra']['finite']}, losses {losses}")
    check(abs(psnr - bench.INTERP_PSNR_DB) <= 0.1,
          f"interp: PSNR {psnr} dB, expected {bench.INTERP_PSNR_DB} ± 0.1")
    log(f"(d) interp: frame-interpolation net {res['value']:.3f} ms/frame at "
        f"256², PSNR vs middle frame {psnr:.3f} dB (expected "
        f"{bench.INTERP_PSNR_DB}), 3 train steps, L1 losses {losses}")
    return results


def phase_e(results: dict, smi: str) -> None:
    res = results["render_fps_spheres1080_1m_1920x1080"]
    ex = res["extra"]
    runs = ex["scan_fps_runs"]
    log(f"(e) spheres1080_1m on {smi}: scan median {res['value']:.2f} FPS "
        f"of {len(runs)} scans of {ex['iters']} frames (min {min(runs):.2f}, "
        f"max {max(runs):.2f}), interactive p50 "
        f"{ex['interactive_ms_p50']:.2f} ms p90 "
        f"{ex['interactive_ms_p90']:.2f} ms (informational)")


def phase_four(bench) -> None:
    """ultra4k in 4 row bands over 4 cards vs the same frame on one card:
    depth within 1 ulp, identical winner ids."""
    import jax
    import numpy as np

    check(len(jax.devices()) >= 4, f"--four needs 4 cards, JAX found "
          f"{len(jax.devices())}")
    outs = []
    for bands in (4, 1):
        r, _, _ = bench.build_scene("ultra4k", bands=bands)
        t0 = time.perf_counter()
        out = jax.block_until_ready(r.render_viewport(r.active_viewport))
        aux = np.asarray(out.aux).reshape(-1, 2).sum(axis=0)
        check(aux.sum() == 0, f"bands={bands}: aux {aux.tolist()}")
        n_dev = len(out.depth.sharding.device_set)
        check(n_dev == bands, f"bands={bands} rendered on {n_dev} cards")
        log(f"(four) ultra4k bands={bands}: first frame "
            f"{time.perf_counter() - t0:.1f} s on {n_dev} card(s), aux [0, 0]")
        outs.append(out)
    banded, single = outs
    d4, d1 = np.asarray(banded.depth), np.asarray(single.depth)
    t4, t1 = np.asarray(banded.tri_id), np.asarray(single.tri_id)
    ulp = np.abs(d4.view(np.int32).astype(np.int64)
                 - d1.view(np.int32).astype(np.int64))
    c4 = np.asarray(banded.color).astype(int)
    c1 = np.asarray(single.color).astype(int)
    log(f"(four) banded vs one card: {int((t4 != t1).sum())} tid "
        f"mismatches, max depth diff {int(ulp.max())} ulp, max color diff "
        f"{int(np.abs(c4 - c1).max())} LSB")
    check((t4 == t1).all() and ulp.max() <= 1,
          "banded frame differs from the single-card frame")


def main(argv) -> int:
    four = "--four" in argv
    device = None
    try:
        smi = phase_a()
        if not four:
            phase_b()
        sys.path.insert(0, ROOT)
        import jax

        import bench
        from trident.core.platform import compile_cache_dir

        compile_cache_dir()
        devs = jax.devices()
        check(devs[0].platform == "gpu", f"JAX platform {devs[0].platform}")
        device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
                  "count": len(devs)}
        log(f"(a) JAX: {device}")
        log(smi)
        if four:
            phase_four(bench)
        else:
            check(len(devs) == 1, f"expected one card, JAX found {len(devs)}")
            phase_c(bench)
            phase_e(phase_d(bench), smi)
    except Exception as exc:  # report any phase's failure, exit non-zero
        log(f"FAILED: {type(exc).__name__}: {exc}")
        print(json.dumps({"ok": False, "error": f"{type(exc).__name__}",
                          "device": device}), flush=True)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
