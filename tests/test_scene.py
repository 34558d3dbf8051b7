"""Scene save/load roundtrip, play-mode sandboxing, registry semantics."""

import os

import numpy as np
import pytest

from trident.ecs.components import (
    AnimationComponent, CameraComponent, LightComponent, LightType,
    MeshComponent, ProjectionType, ScriptComponent, SpriteComponent,
    TagComponent, TextureComponent, TransformComponent, UUIDComponent,
)
from trident.ecs.registry import Registry
from trident.ecs.scene import Scene
from trident.geometry.primitives import PrimitiveType


def build_scene():
    scene = Scene()
    reg = scene.editor_registry
    e = reg.create()
    t = reg.add(e, TransformComponent())
    t.position = np.array([1.5, -2.0, 3.25], np.float32)
    t.rotation = np.array([10.0, 20.0, 30.0], np.float32)
    t.scale = np.array([2.0, 2.0, 2.0], np.float32)
    reg.add(e, TagComponent('cube "one"'))
    reg.add(e, MeshComponent(mesh_index=5, material_index=2,
                             primitive=PrimitiveType.CUBE))
    reg.add(e, TextureComponent(path="Assets/tex.png", slot=3))
    reg.add(e, SpriteComponent(texture_path="spr.png", tiling=2.0, atlas_index=4))
    anim = reg.add(e, AnimationComponent(skeleton_asset="model.gltf",
                                         clip_name="Run", speed=1.5))
    anim.bone_matrices = np.arange(32, dtype=np.float32).reshape(2, 4, 4)
    light_e = reg.create()
    reg.add(light_e, TransformComponent())
    reg.add(light_e, LightComponent(light_type=LightType.POINT,
                                    color=np.array([1, 0.5, 0.25], np.float32),
                                    intensity=4.0, range=12.0))
    reg.add(light_e, ScriptComponent(path="scripts/foo.py", autostart=True,
                                     module="mymod:tick"))
    return scene, e, light_e


def test_save_load_roundtrip(tmp_path):
    scene, e, light_e = build_scene()
    path = str(tmp_path / "test.trident")
    scene.save(path)

    loaded = Scene()
    loaded.load(path)
    reg = loaded.editor_registry
    # default camera + 2 saved entities... but save included the seeded camera
    tags = [reg.get(ent, TagComponent).tag
            for ent in reg.alive() if reg.has(ent, TagComponent)]
    assert 'cube "one"' in tags

    cube = next(ent for ent in reg.alive()
                if reg.has(ent, TagComponent)
                and reg.get(ent, TagComponent).tag == 'cube "one"')
    t = reg.get(cube, TransformComponent)
    np.testing.assert_allclose(t.position, [1.5, -2.0, 3.25], atol=1e-5)
    np.testing.assert_allclose(t.rotation, [10, 20, 30], atol=1e-4)
    mesh = reg.get(cube, MeshComponent)
    assert mesh.primitive == PrimitiveType.CUBE
    assert mesh.material_index == 2
    tex = reg.get(cube, TextureComponent)
    assert tex.path == "Assets/tex.png" and tex.slot == 3
    spr = reg.get(cube, SpriteComponent)
    assert spr.tiling == 2.0 and spr.atlas_index == 4
    anim = reg.get(cube, AnimationComponent)
    assert anim.clip_name == "Run" and anim.speed == 1.5
    np.testing.assert_allclose(anim.bone_matrices.reshape(-1),
                               np.arange(32), atol=1e-4)

    light = next(ent for ent in reg.alive() if reg.has(ent, LightComponent))
    lc = reg.get(light, LightComponent)
    assert lc.light_type == LightType.POINT
    np.testing.assert_allclose(lc.color, [1, 0.5, 0.25], atol=1e-5)
    sc = reg.get(light, ScriptComponent)
    assert sc.module == "mymod:tick" and sc.autostart


def test_play_mode_sandbox():
    scene, e, _ = build_scene()
    scene.play()
    assert scene.playing
    rt = scene.runtime_registry
    # mutate the runtime copy
    rt.get(e, TransformComponent).position[0] = 99.0
    rt.destroy(e)
    assert not rt.is_alive(e)
    # editor registry untouched
    assert scene.editor_registry.is_alive(e)
    assert scene.editor_registry.get(e, TransformComponent).position[0] == 1.5
    scene.stop()
    assert not scene.playing
    assert scene.registry is scene.editor_registry


def test_script_execution_during_play(tmp_path):
    scene = Scene()
    reg = scene.editor_registry
    e = reg.create()
    reg.add(e, TransformComponent())
    reg.add(e, ScriptComponent(path="x", autostart=True, module="dummy"))
    calls = []
    scene.script_runner = lambda ent, r, script, dt: calls.append((ent, dt))
    scene.play()
    scene.update(0.016)
    scene.update(0.016)
    assert len(calls) == 2


def test_default_camera_seeded():
    scene = Scene()
    found = scene.editor_registry.single(CameraComponent)
    assert found is not None
    entity, cam = found
    assert cam.primary
    t = scene.editor_registry.get(entity, TransformComponent)
    np.testing.assert_allclose(t.position, [0, 100, 255])


def test_registry_uuid_autoattach():
    reg = Registry()
    e = reg.create()
    assert reg.has(e, UUIDComponent)
    assert reg.get(e, UUIDComponent).uuid != 0


def test_roundtrip_tint_uv_and_newline_tag(tmp_path):
    """Render-affecting fields (mesh tint, texture UV transform) and
    newline-bearing strings must survive save->load exactly."""
    scene = Scene()
    reg = scene.editor_registry
    e = reg.create()
    reg.add(e, TagComponent("line1\nline2"))
    m = reg.add(e, MeshComponent(primitive=PrimitiveType.CUBE))
    m.tint = np.array([1.0, 0.25, 0.1, 0.8], np.float32)
    tex = reg.add(e, TextureComponent(path="checker"))
    tex.uv_scale = np.array([2.0, 3.0], np.float32)
    tex.uv_offset = np.array([0.25, -0.5], np.float32)
    tex.tiling = 4.0
    p = str(tmp_path / "s.trident")
    scene.save(p)
    scene2 = Scene()
    scene2.load(p)
    reg2 = scene2.editor_registry
    e2 = next(en for en, (tag,) in reg2.view(TagComponent)
              if tag.tag.startswith("line1"))
    assert reg2.get(e2, TagComponent).tag == "line1\nline2"
    np.testing.assert_allclose(reg2.get(e2, MeshComponent).tint,
                               [1.0, 0.25, 0.1, 0.8], atol=1e-5)
    t2 = reg2.get(e2, TextureComponent)
    np.testing.assert_allclose(t2.uv_scale, [2.0, 3.0], atol=1e-5)
    np.testing.assert_allclose(t2.uv_offset, [0.25, -0.5], atol=1e-5)
    assert t2.tiling == pytest.approx(4.0)


def test_load_reresolves_texture_slots(tmp_path):
    """Saved texture slots are session-local acquire order: load must
    re-resolve by PATH (lookup for live keys, slot-0 white otherwise),
    never trust the stored index."""
    from trident.core.config import EngineConfig, RenderConfig
    from trident.io.image import checkerboard
    from trident.render.renderer import Renderer

    r = Renderer(EngineConfig(render=RenderConfig(width=32, height=32,
                                                  use_pallas=False)))
    scene = Scene(renderer=r)
    reg = scene.editor_registry
    r.set_active_registry(reg)
    slot = r.acquire_texture("checker", checkerboard(16, 4))
    e = reg.create()
    reg.add(e, MeshComponent(primitive=PrimitiveType.CUBE))
    reg.add(e, TextureComponent(path="checker", slot=slot))
    stale = reg.create()
    reg.add(stale, TextureComponent(path="never_acquired", slot=77))
    p = str(tmp_path / "s.trident")
    scene.save(p)
    scene.load(p)
    reg2 = scene.editor_registry
    texes = {t.path: t for _e, (t,) in reg2.view(TextureComponent)}
    assert texes["checker"].slot == slot          # live key resolves
    assert not texes["checker"].dirty
    assert texes["never_acquired"].slot == 0      # white fallback, not 77
    assert texes["never_acquired"].dirty


def test_script_destroying_entity_does_not_skip_updates(tmp_path):
    """A script that destroys its own entity mutates the alive list; the
    NEXT entity's script must still run that frame."""
    calls = []

    def runner(entity, registry, script, dt):
        calls.append(script.module)
        if script.module == "killer":
            registry.destroy(entity)

    scene = Scene()
    reg = scene.editor_registry
    for name in ("killer", "survivor_a", "survivor_b"):
        e = reg.create()
        reg.add(e, ScriptComponent(path=f"{name}.py", autostart=True,
                                   module=name))
    scene.script_runner = runner
    scene.play()
    scene.update(0.016)
    assert calls.count("survivor_a") == 1
    assert calls.count("survivor_b") == 1
