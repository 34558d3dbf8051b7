"""Platform selection, the compile-cache helper, and the entry points that
must refuse a machine without a GPU (chip_smoke.py, bench.py)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import jax

from trident.core import platform as plat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("backend", ["rocm", "METAL"])
def test_platform_raises_on_unknown(monkeypatch, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        plat.platform()
    with pytest.raises(RuntimeError):
        plat.raster_mode()


@pytest.mark.parametrize("backend,use_pallas,want", [
    ("gpu", None, "pallas"), ("cpu", None, "ref"),
    ("cpu", True, "pallas"), ("gpu", False, "ref")])
def test_raster_mode_by_platform(monkeypatch, backend, use_pallas, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert plat.raster_mode(use_pallas) == want


def test_interpret_only_on_cpu(monkeypatch):
    assert plat.raster_interpret() is True           # this suite: the CPU
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert plat.raster_interpret() is False


def test_compile_cache_dir_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert plat.compile_cache_dir() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # set nothing


def test_compile_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = plat.compile_cache_dir()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _run(script_dir, *args):
    env = {k: v for k, v in os.environ.items()}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, "chip_smoke.py", *args],
                          cwd=script_dir, env=env, capture_output=True,
                          text=True, timeout=600)


def test_chip_smoke_fails_without_gpu():
    res = _run(ROOT)
    assert res.returncode != 0
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["ok"] is False


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run(tmp_path)
    assert res.returncode != 0
    assert json.loads(res.stdout.strip().splitlines()[-1])["ok"] is False


def test_bench_refuses_cpu():
    sys.path.insert(0, ROOT)
    import bench

    with pytest.raises(SystemExit, match="refuses platform"):
        bench.require_gpu()


def test_more_bands_than_devices_raises():
    from trident.core.config import EngineConfig, RenderConfig
    from trident.ecs.registry import Registry
    from trident.render.renderer import Renderer

    r = Renderer(EngineConfig(render=RenderConfig(
        width=32, height=32, bands=len(jax.devices()) + 1)))
    r.set_active_registry(Registry())
    with pytest.raises(ValueError, match="devices"):
        r.render_viewport()


def test_render_path_imports_no_ai_package():
    """A plain frame imports neither trident.ai nor any of the
    packages the card's machine may lack."""
    code = (
        "import sys, numpy as np\n"
        "from trident.core.config import EngineConfig, RenderConfig\n"
        "from trident.ecs import Registry, TransformComponent, "
        "MeshComponent\n"
        "from trident.geometry.primitives import PrimitiveType\n"
        "from trident.render.renderer import Renderer\n"
        "r = Renderer(EngineConfig(render=RenderConfig(width=32, "
        "height=32)))\n"
        "reg = Registry(); r.set_active_registry(reg)\n"
        "e = reg.create(); reg.add(e, TransformComponent())\n"
        "reg.add(e, MeshComponent(mesh_index=r.ensure_primitive("
        "PrimitiveType.CUBE)))\n"
        "r.editor_camera.set_position([0, 0, 3])\n"
        "r.read_frame()\n"
        "bad = [m for m in ('trident.ai', 'flax', 'orbax', 'PIL', "
        "'imageio') if m in sys.modules]\n"
        "print(bad)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"
