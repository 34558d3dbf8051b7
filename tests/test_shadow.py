"""Shadow mapping: the two-pass render graph."""

import numpy as np
import pytest

from trident.core.config import EngineConfig, RenderConfig
from trident.ecs.components import (
    LightComponent, LightType, MeshComponent, TransformComponent,
)
from trident.ecs.registry import Registry
from trident.geometry.primitives import PrimitiveType
from trident.render.renderer import Renderer


def build(shadows=True):
    cfg = EngineConfig(render=RenderConfig(width=128, height=128,
                                           use_pallas=False, shadows=shadows,
                                           shadow_map_size=256))
    r = Renderer(cfg)
    reg = Registry()
    r.set_active_registry(reg)
    # ground plane
    ground = reg.create()
    tg = reg.add(ground, TransformComponent())
    tg.position = np.array([0, -0.55, 0], np.float32)
    tg.scale = np.array([8, 0.1, 8], np.float32)
    reg.add(ground, MeshComponent(mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
    # floating cube casting the shadow
    cube = reg.create()
    tc = reg.add(cube, TransformComponent())
    tc.position = np.array([0, 0.8, 0], np.float32)
    tc.scale = np.array([0.8, 0.8, 0.8], np.float32)
    reg.add(cube, MeshComponent(mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
    # sun nearly straight down
    sun = reg.create()
    reg.add(sun, TransformComponent())
    reg.add(sun, LightComponent(light_type=LightType.DIRECTIONAL,
                                direction=np.array([0.15, -1.0, 0.1], np.float32),
                                color=np.array([1, 1, 1], np.float32),
                                intensity=4.0, cast_shadows=True))
    r.editor_camera.set_position([0, 4.5, 5.5])
    r.editor_camera.look_at_target([0, 0, 0])
    return r


def test_shadow_darkens_ground():
    lit = build(shadows=False).read_frame().astype(np.float32)
    shadowed = build(shadows=True).read_frame().astype(np.float32)
    # pixel under the cube should be darker with shadows on
    # (cube is at the image center; ground directly below it is occluded)
    center_lit = lit[74:86, 58:70, :3].mean()
    center_shadowed = shadowed[74:86, 58:70, :3].mean()
    assert center_shadowed < center_lit - 10.0
    # far corner of the ground is NOT in shadow → roughly unchanged
    corner_lit = lit[100:110, 14:24, :3].mean()
    corner_shadowed = shadowed[100:110, 14:24, :3].mean()
    assert abs(corner_lit - corner_shadowed) < 8.0


def test_pcf_fractional_penumbra():
    """pcf=True must yield fractional lit values across a shadow boundary
    (comparison-before-blend), while pcf=False is strictly binary."""
    import jax.numpy as jnp

    from trident.ops.shadow import shadow_factor
    from trident.render.types import ShadowParams

    s = 16
    depth = np.ones((s, s), np.float32)
    depth[:, :s // 2] = 0.2              # left half: occluder at 0.2
    sp = ShadowParams(depth=jnp.asarray(depth),
                      light_vp=jnp.eye(4, dtype=jnp.float32),
                      enabled=jnp.asarray(True),
                      bias=jnp.asarray(1e-3, jnp.float32))
    # identity light_vp: ndc == world; receiver at z=0.5 crossing x=0
    xs = np.linspace(-0.9, 0.9, 64, dtype=np.float32)
    world = jnp.asarray(np.stack(
        [xs, np.zeros_like(xs), np.full_like(xs, 0.5)], axis=-1))
    hard = np.asarray(shadow_factor(sp, world, pcf=False))[..., 0]
    soft = np.asarray(shadow_factor(sp, world, pcf=True))[..., 0]
    assert set(np.unique(hard)) <= {0.0, 1.0}
    assert ((soft > 0.05) & (soft < 0.95)).any()     # penumbra band exists
    assert soft[0] == 0.0 and soft[-1] == 1.0        # extremes unchanged


def test_pcf_render_touches_only_shadow_edges():
    r = build(shadows=True)
    r.config.render.shadow_pcf = True
    soft = r.read_frame().astype(np.float32)[..., :3]
    hard = build(shadows=True).read_frame().astype(np.float32)[..., :3]
    diff = np.abs(soft - hard).max(axis=-1)
    changed = diff > 3.0
    assert changed.any()                  # PCF actually softened something
    assert changed.mean() < 0.08          # ...but only a thin penumbra ring
    # every changed pixel sits next to an unchanged one (it's a 1-texel
    # filter: changes form edges, not areas)
    assert np.abs(soft - hard).mean() < 3.0


def test_no_shadow_without_caster_flag():
    r = build(shadows=True)
    for _e, (lc,) in r.registry.view(LightComponent):
        lc.cast_shadows = False
    img1 = r.read_frame().astype(np.float32)
    r2 = build(shadows=False)
    img2 = r2.read_frame().astype(np.float32)
    np.testing.assert_allclose(img1, img2, atol=1.0)
