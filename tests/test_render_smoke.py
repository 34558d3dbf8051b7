"""End-to-end render smoke tests: cube on screen, depth ordering, lighting."""

import numpy as np
import pytest

from trident.core.config import EngineConfig, RenderConfig
from trident.ecs.components import (
    LightComponent, LightType, MeshComponent, TransformComponent,
)
from trident.ecs.registry import Registry
from trident.geometry.primitives import PrimitiveType
from trident.io.image import checkerboard
from trident.render.renderer import Renderer


def make_renderer(w=128, h=128):
    cfg = EngineConfig(render=RenderConfig(width=w, height=h, texture_size=64,
                                           use_pallas=False))
    r = Renderer(cfg)
    reg = Registry()
    r.set_active_registry(reg)
    return r, reg


def spawn_cube(r, reg, pos=(0, 0, 0), scale=(1, 1, 1), rot=(0, 0, 0)):
    e = reg.create()
    t = reg.add(e, TransformComponent())
    t.position = np.array(pos, np.float32)
    t.scale = np.array(scale, np.float32)
    t.rotation = np.array(rot, np.float32)
    mesh_idx = r.ensure_primitive(PrimitiveType.CUBE)
    reg.add(e, MeshComponent(mesh_index=mesh_idx, primitive=PrimitiveType.CUBE))
    return e


def test_cube_visible_center():
    r, reg = make_renderer()
    spawn_cube(r, reg)
    r.editor_camera.set_position([0, 0, 3])
    r.editor_camera.look_at_target([0, 0, 0])
    img = r.read_frame()
    assert img.shape == (128, 128, 4)
    out = r.viewports[0].last_frame
    tri = np.asarray(out.tri_id)
    # center pixel hits the cube, corners are background
    assert tri[64, 64] >= 0
    assert tri[2, 2] == -1
    # lit cube face must be brighter than background
    assert img[64, 64, :3].astype(int).sum() > img[2, 2, :3].astype(int).sum()


def test_depth_ordering():
    r, reg = make_renderer()
    spawn_cube(r, reg, pos=(0, 0, 0))            # near cube
    spawn_cube(r, reg, pos=(0, 0, -5), scale=(16, 16, 1))  # far big wall
    r.editor_camera.set_position([0, 0, 3])
    r.editor_camera.look_at_target([0, 0, 0])
    out = r.render_viewport(0)
    depth = np.asarray(out.depth)
    tri = np.asarray(out.tri_id)
    # center: near cube (12 tris → ids < 12); edge: wall (ids >= 12)
    assert tri[64, 64] < 12
    assert tri[64, 120] >= 12
    assert depth[64, 64] < depth[64, 120]


def test_backface_culling_inside_cube():
    r, reg = make_renderer()
    spawn_cube(r, reg, scale=(10, 10, 10))
    # camera inside the cube: all faces are back-facing → nothing drawn
    r.editor_camera.set_position([0, 0, 0])
    r.editor_camera.look_at_target([0, 0, -1])
    out = r.render_viewport(0)
    tri = np.asarray(out.tri_id)
    assert (tri == -1).all()


def test_texture_sampling():
    r, reg = make_renderer()
    e = spawn_cube(r, reg)
    slot = r.acquire_texture("checker", checkerboard(32, 4))
    assert slot == 1
    from trident.ecs.components import TextureComponent
    reg.add(e, TextureComponent(path="checker", slot=slot))
    r.editor_camera.set_position([0, 0, 2])
    r.editor_camera.look_at_target([0, 0, 0])
    img = r.read_frame().astype(np.float32)
    # checkerboard front face: variance across the face must be significant
    face = img[40:88, 40:88, :3]
    assert face.std() > 20.0


def test_point_light_falloff():
    r, reg = make_renderer()
    spawn_cube(r, reg, pos=(0, 0, 0), scale=(8, 8, 1))
    e = reg.create()
    t = reg.add(e, TransformComponent())
    t.position = np.array([0, 0, 1.2], np.float32)
    reg.add(e, LightComponent(light_type=LightType.POINT,
                              color=np.array([1, 1, 1], np.float32),
                              intensity=5.0, range=4.0))
    r.editor_camera.set_position([0, 0, 4])
    r.editor_camera.look_at_target([0, 0, 0])
    img = r.read_frame().astype(np.float32)
    center = img[60:68, 60:68, :3].mean()
    edge = img[4:12, 4:12, :3].mean()
    assert center > edge + 10.0


def test_resize_and_second_viewport():
    r, reg = make_renderer()
    spawn_cube(r, reg)
    r.editor_camera.set_position([0, 0, 3])
    r.editor_camera.look_at_target([0, 0, 0])
    r.set_viewport(1, 64, 96)
    out = r.render_viewport(1)
    assert np.asarray(out.color).shape == (96, 64, 4)


def test_draw_frame_telemetry():
    r, reg = make_renderer(64, 64)
    spawn_cube(r, reg)
    r.editor_camera.set_position([0, 0, 3])
    for _ in range(3):
        r.draw_frame()
    stats = r.timing.stats()
    assert stats.sample_count == 3
    assert stats.avg_ms > 0
    assert r.stats_models == 1
    assert r.stats_triangles == 12


def test_idle_frame_cache_reuses_output():
    """Unchanged inputs skip the dispatch entirely (editor-idle path);
    any mutation invalidates."""
    import numpy as np

    from trident.core.config import EngineConfig, RenderConfig
    from trident.ecs.components import MeshComponent, TransformComponent
    from trident.ecs.registry import Registry
    from trident.geometry.primitives import PrimitiveType
    from trident.render.renderer import Renderer

    r = Renderer(EngineConfig(render=RenderConfig(width=32, height=32)))
    reg = Registry()
    r.set_active_registry(reg)
    e = reg.create()
    t = reg.add(e, TransformComponent())
    reg.add(e, MeshComponent(mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
    a = r.render_viewport(0)
    b = r.render_viewport(0)
    assert b is a                       # cached, no new dispatch
    t.rotation = np.array([0.0, 10.0, 0.0], np.float32)
    c = r.render_viewport(0)
    assert c is not a                   # transform change invalidates
    d = r.render_viewport(0)
    assert d is c
