"""Skybox loading + application shell loop."""

import os

import numpy as np
import pytest

from trident.assets.skybox import (
    discover_faces, load_skybox, solid_skybox,
)
from trident.io.image import save_png


def test_discover_and_load_faces(tmp_path):
    for token in ("px", "nx", "py", "ny", "pz", "nz"):
        img = np.full((8, 8, 3), 100, np.uint8)
        save_png(str(tmp_path / f"sky_{token}.png"), img)
    paths = discover_faces(str(tmp_path))
    assert paths is not None and len(paths) == 6
    faces = load_skybox(str(tmp_path))
    assert faces.shape == (6, 8, 8, 3)
    np.testing.assert_allclose(faces, 100 / 255.0, atol=1e-3)


def test_skybox_fallback(tmp_path):
    faces = load_skybox(str(tmp_path / "missing"))
    assert faces.shape[0] == 6
    assert (faces == faces[0, 0, 0]).all()


def test_skybox_renders_background():
    import jax

    from trident.core.config import EngineConfig, RenderConfig
    from trident.ecs.registry import Registry
    from trident.render.renderer import Renderer

    r = Renderer(EngineConfig(render=RenderConfig(width=64, height=64,
                                                  use_pallas=False)))
    reg = Registry()
    r.set_active_registry(reg)
    faces = solid_skybox((1.0, 0.0, 0.0), edge=4)
    faces[2] = [0.0, 1.0, 0.0]  # +y face green
    r.set_skybox(faces)
    r.editor_camera.set_position([0, 0, 0])
    r.editor_camera.set_rotation([89.0, 0, 0])  # look up
    img = r.read_frame()
    center = img[32, 32]
    assert center[1] > 150 and center[0] < 100  # green up-face


def test_application_headless_loop(tmp_path):
    from trident.app import Application, Layer
    from trident.core.config import EngineConfig, RenderConfig
    from trident.core.events import FileDropEvent, WindowCloseEvent
    from trident.ecs.components import MeshComponent, TransformComponent
    from trident.geometry.primitives import PrimitiveType

    app = Application(EngineConfig(render=RenderConfig(width=48, height=48,
                                                       use_pallas=False)))
    calls = {"update": 0, "render": 0}

    class TestLayer(Layer):
        def update(self, app, dt):
            calls["update"] += 1

        def render(self, app):
            calls["render"] += 1

    app.push_layer(TestLayer())
    # spawn a cube via the engine API
    reg = app.scene.editor_registry
    e = reg.create()
    reg.add(e, TransformComponent())
    reg.add(e, MeshComponent(mesh_index=app.renderer.ensure_primitive(PrimitiveType.CUBE)))
    app.renderer.editor_camera.set_position([0, 0, 3])

    app.run(frames=3)
    assert calls["update"] == 3 and calls["render"] == 3
    stats = app.renderer.timing.stats()
    assert stats.sample_count == 3

    # file drop imports an asset
    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    before = len(reg)
    app.post_event(FileDropEvent(paths=[str(obj)]))
    assert len(reg) == before + 1

    # close event stops the loop
    app.running = True
    app.post_event(WindowCloseEvent())
    assert not app.running
    app.shutdown()


import pytest as _pytest


@_pytest.mark.skipif(not __import__("os").path.isdir(
    "/root/reference/Trident-Forge/Assets/Skyboxes"),
    reason="reference assets not mounted")
def test_reference_skybox_assets_load():
    """The reference's shipped cubemap faces load through our discovery."""
    faces = load_skybox("/root/reference/Trident-Forge/Assets/Skyboxes")
    assert faces.shape == (6, 512, 512, 3)
    assert 0.0 <= float(faces.min()) and float(faces.max()) <= 1.0
    # real sky: faces differ from each other
    assert abs(faces[2].mean() - faces[3].mean()) > 0.01


def test_skybox_mip_chain_selects_by_viewport(tmp_path):
    """A KTX2 cubemap's full mip chain loads (reference uploads chains,
    TextureLoader.cpp:417) and rendering picks the level matching the
    viewport's angular resolution: a tiny viewport must sample a coarser
    level, and the frame must still show the right face color."""
    from trident.assets.ktx2 import write_ktx2
    from trident.assets.skybox import load_skybox_mips
    from trident.core.config import EngineConfig, RenderConfig
    from trident.ecs.registry import Registry
    from trident.render.renderer import Renderer

    # level 0: 256px red cube with green +y; level chain down to 2px —
    # coarser levels DIFFER (blue +y) so the test can tell which was used
    def cube(edge, up):
        f = np.full((6, edge, edge, 4), 0, np.uint8)
        f[..., 0] = 200
        f[..., 3] = 255
        f[2, ..., :3] = up
        return f

    base = cube(64, (0, 200, 0))
    mips = [cube(64 >> k, (0, 0, 200)) for k in range(1, 7)]
    path = str(tmp_path / "sky.ktx2")
    write_ktx2(path, base, cubemap=True, mips=mips)

    levels = load_skybox_mips(path)
    assert len(levels) == 7 and levels[0].shape == (6, 64, 64, 3)
    assert levels[3].shape == (6, 8, 8, 3)

    r = Renderer(EngineConfig(render=RenderConfig(width=48, height=48,
                                                  use_pallas=False)))
    reg = Registry()
    r.set_active_registry(reg)
    r.set_skybox(levels[0], mips=levels[1:])
    # big viewport wants the fine level; small wants a coarse one
    fine = r._skybox_for(2048, 60.0)
    coarse = r._skybox_for(8, 60.0)
    assert fine.faces.shape[1] == 64
    assert coarse.faces.shape[1] < 64

    r.editor_camera.set_position([0, 0, 0])
    r.editor_camera.set_rotation([89.0, 0, 0])       # look up
    img = np.asarray(r.read_frame())
    c = img[24, 24]
    # 48px viewport at 60° wants ~63 texels/face → level 0 (green +y)
    assert c[1] > 120 and c[2] < 100
