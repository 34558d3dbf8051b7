"""Hot-reloadable user shading modules (render/shader_hook.py).

Reference parity: Pipeline.cpp:997-1058 rebuilds the Vulkan pipeline when
fragment-shader source changes on disk, and a failed compile keeps the old
pipeline. Here the "shader" is a Python module whose `shade(...)` replaces
ops/shading.shade_pbr as a jit static; a reload is a retrace."""

import os
import textwrap

import numpy as np

from trident.core.config import EngineConfig, RenderConfig
from trident.ecs import (MeshComponent, Registry, TextureComponent,
                             TransformComponent)
from trident.geometry.primitives import PrimitiveType
from trident.io.image import checkerboard
from trident.render.renderer import Renderer

ALBEDO_SHADER = textwrap.dedent("""\
    def shade(world, normal, albedo, metallic, roughness,
              ambient_strength, camera_pos, lights, dir_shadow=None):
        # unlit: pass the albedo straight through
        return albedo
""")

RED_SHADER = textwrap.dedent("""\
    import jax.numpy as jnp

    def shade(world, normal, albedo, metallic, roughness,
              ambient_strength, camera_pos, lights, dir_shadow=None):
        return jnp.ones_like(albedo) * jnp.asarray([1.0, 0.0, 0.0])
""")


def _cube_renderer(use_pallas=False, **render_kw):
    r = Renderer(EngineConfig(render=RenderConfig(
        width=64, height=64, use_pallas=use_pallas, **render_kw)))
    reg = Registry()
    r.set_active_registry(reg)
    slot = r.acquire_texture("checker", checkerboard(32, 4))
    e = reg.create()
    t = reg.add(e, TransformComponent())
    t.rotation = np.array([20.0, 35.0, 0.0], np.float32)
    reg.add(e, MeshComponent(mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
    reg.add(e, TextureComponent(path="checker", slot=slot))
    r.editor_camera.set_position([0, 0.6, 3.0])
    r.editor_camera.look_at_target([0, 0, 0])
    return r


def test_custom_shader_replaces_pbr_and_hot_swaps(tmp_path):
    shader = tmp_path / "unlit.py"
    shader.write_text(ALBEDO_SHADER)

    r = _cube_renderer()
    pbr = np.asarray(r.read_frame())
    assert r.set_custom_shader(str(shader))
    unlit = np.asarray(r.read_frame())
    # unlit albedo differs from lit PBR on the cube body
    assert np.abs(unlit.astype(int) - pbr.astype(int)).max() > 8

    # the unlit checker albedo is grayscale; a red shader is not
    shader.write_text(RED_SHADER)
    assert r.set_custom_shader(str(shader))
    red = np.asarray(r.read_frame())
    body = red[np.asarray(r.viewports[0].last_frame.tri_id) >= 0]
    assert body[:, 0].mean() > 100 and body[:, 1].max() <= 30


def test_failed_reload_keeps_previous_shader(tmp_path):
    shader = tmp_path / "s.py"
    shader.write_text(ALBEDO_SHADER)
    r = _cube_renderer()
    assert r.set_custom_shader(str(shader))
    good = np.asarray(r.read_frame())
    v = r.shader_hook.version

    shader.write_text("def shade(:  # syntax error\n")
    assert not r.set_custom_shader(str(shader))
    assert r.shader_hook.version == v
    assert "SyntaxError" in r.shader_hook.last_error
    after = np.asarray(r.read_frame())
    np.testing.assert_array_equal(good, after)

    shader.write_text("x = 1\n")  # imports fine, no shade()
    assert not r.set_custom_shader(str(shader))
    assert "shade" in r.shader_hook.last_error

    r.clear_custom_shader()
    assert r.shader_hook.fn is None


def test_custom_shader_on_kernel_path_and_idle_cache(tmp_path):
    # the Pallas forward path threads shader_fn through the resolve-kernel
    # shading (deferred_shade_attrs); CPU runs it under interpret mode
    shader = tmp_path / "unlit.py"
    shader.write_text(ALBEDO_SHADER)
    r = _cube_renderer(use_pallas=True)
    base = np.asarray(r.read_frame())
    cached = r.viewports[0].last_frame
    # idle: identical inputs reuse the cached frame object
    r.render_viewport(0)
    assert r.viewports[0].last_frame is cached
    assert r.set_custom_shader(str(shader))
    # the shader version is in the idle-cache signature → re-renders
    out = np.asarray(r.read_frame())
    assert np.abs(out.astype(int) - base.astype(int)).max() > 8


def test_custom_shader_composes_with_banding(tmp_path):
    # shader_fn rides through render_frame_banded's shard_map as a jit
    # static; two row bands must produce the single-chip image exactly
    import jax

    if len(jax.devices()) < 2:
        import pytest
        pytest.skip("needs 2 devices")
    shader = tmp_path / "unlit.py"
    shader.write_text(ALBEDO_SHADER)

    frames = {}
    for bands in (1, 2):
        r = _cube_renderer(bands=bands)
        assert r.set_custom_shader(str(shader))
        frames[bands] = np.asarray(r.read_frame())
    np.testing.assert_array_equal(frames[1], frames[2])


def test_watcher_reloads_active_shader(tmp_path):
    from trident.app import Application

    assets = tmp_path / "Assets"
    (assets / "Shaders").mkdir(parents=True)
    (assets / "Models").mkdir()
    (assets / "Textures").mkdir()
    shader = assets / "Shaders" / "unlit.py"
    shader.write_text(ALBEDO_SHADER)

    app = Application(EngineConfig(assets_root=str(assets),
                                   render=RenderConfig(width=32, height=32,
                                                       use_pallas=False)))
    try:
        app.renderer.set_custom_shader(str(shader))
        v = app.renderer.shader_hook.version
        # prime the watcher baseline, then touch the file
        app.file_watcher.poll(now=1e9)
        shader.write_text(RED_SHADER)
        os.utime(shader, (os.stat(shader).st_atime,
                          os.stat(shader).st_mtime + 5))
        app.file_watcher.poll(now=2e9)
        app.process_reload_events()
        assert app.renderer.shader_hook.version == v + 1
    finally:
        app.shutdown()
