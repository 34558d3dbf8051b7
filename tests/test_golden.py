"""Golden-image regression: the deterministic reference scene must render
pixel-stable across refactors (SURVEY §4's test-pyramid recommendation).

Regenerate intentionally with:
    python tests/test_golden.py  (writes tests/goldens/scene_128.png)
"""

import os

import numpy as np

from trident.core.config import EngineConfig, RenderConfig
from trident.ecs.components import (
    LightComponent, LightType, MeshComponent, TextureComponent, TransformComponent,
)
from trident.ecs.registry import Registry
from trident.geometry.primitives import PrimitiveType
from trident.io.image import checkerboard, load_rgba8, save_png
from trident.render.renderer import Renderer

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "scene_128.png")


def build_golden_scene() -> Renderer:
    r = Renderer(EngineConfig(render=RenderConfig(
        width=128, height=128, texture_size=64, use_pallas=False,
        shadows=True, shadow_map_size=128)))
    reg = Registry()
    r.set_active_registry(reg)
    slot = r.acquire_texture("checker", checkerboard(64, 8))
    cube = reg.create()
    t = reg.add(cube, TransformComponent())
    t.rotation = np.array([20.0, 35.0, 0.0], np.float32)
    reg.add(cube, MeshComponent(mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
    reg.add(cube, TextureComponent(path="checker", slot=slot))
    sph = reg.create()
    t2 = reg.add(sph, TransformComponent())
    t2.position = np.array([1.1, 0.5, -0.4], np.float32)
    t2.scale = np.array([0.6, 0.6, 0.6], np.float32)
    reg.add(sph, MeshComponent(mesh_index=r.ensure_primitive(PrimitiveType.SPHERE)))
    ground = reg.create()
    tg = reg.add(ground, TransformComponent())
    tg.position = np.array([0, -0.8, 0], np.float32)
    tg.scale = np.array([6, 0.1, 6], np.float32)
    reg.add(ground, MeshComponent(mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
    sun = reg.create()
    reg.add(sun, TransformComponent())
    reg.add(sun, LightComponent(
        light_type=LightType.DIRECTIONAL,
        direction=np.array([-0.35, -1.0, -0.25], np.float32),
        intensity=4.0, cast_shadows=True))
    r.editor_camera.set_position([2.2, 1.6, 3.0])
    r.editor_camera.look_at_target([0.2, 0, 0])
    return r


def test_golden_scene_stable():
    img = build_golden_scene().read_frame()
    golden = load_rgba8(GOLDEN)
    assert img.shape == golden.shape
    diff = np.abs(img.astype(int) - golden.astype(int))
    # float/backend wiggle allowance: tiny per-pixel deltas, and edge/tie
    # pixels may flip — but only a handful of them
    assert (diff > 3).mean() < 0.002, f"{(diff > 3).sum()} pixels drifted"
    assert float(diff.mean()) < 0.35


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    save_png(GOLDEN, build_golden_scene().read_frame())
    print("regenerated", GOLDEN)
