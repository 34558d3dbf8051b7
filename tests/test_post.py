"""Post FX: supersampling resolve + bloom."""

import numpy as np
import jax.numpy as jnp

from trident.core.config import EngineConfig, RenderConfig
from trident.ecs.components import LightComponent, LightType, MeshComponent, TransformComponent
from trident.ecs.registry import Registry
from trident.geometry.primitives import PrimitiveType
from trident.ops.post import bloom, resolve_supersample
from trident.render.renderer import Renderer


def test_resolve_supersample_box():
    img = jnp.arange(4 * 4 * 1, dtype=jnp.float32).reshape(4, 4, 1)
    out = np.asarray(resolve_supersample(img, 2))
    assert out.shape == (2, 2, 1)
    np.testing.assert_allclose(out[0, 0, 0], (0 + 1 + 4 + 5) / 4)


def test_bloom_spreads_highlights():
    hdr = jnp.zeros((64, 64, 3))
    hdr = hdr.at[32, 32].set(50.0)   # one very bright pixel
    out = np.asarray(bloom(hdr, threshold=1.0, strength=1.0))
    # neighborhood gained energy
    assert out[28, 28].sum() > 0.001
    # dark corner unaffected
    assert out[2, 2].sum() < 1e-6


def build(ss=1, use_bloom=False):
    cfg = EngineConfig(render=RenderConfig(
        width=96, height=96, use_pallas=False, supersample=ss,
        bloom=use_bloom, bloom_threshold=0.5, bloom_strength=1.0))
    r = Renderer(cfg)
    reg = Registry()
    r.set_active_registry(reg)
    e = reg.create()
    t = reg.add(e, TransformComponent())
    t.rotation = np.array([25.0, 40.0, 0.0], np.float32)
    reg.add(e, MeshComponent(mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
    sun = reg.create()
    reg.add(sun, TransformComponent())
    reg.add(sun, LightComponent(light_type=LightType.DIRECTIONAL,
                                direction=np.array([-0.3, -1, -0.4], np.float32),
                                intensity=30.0))
    r.editor_camera.set_position([0, 0.6, 2.6])
    r.editor_camera.look_at_target([0, 0, 0])
    return r


def test_supersample_render_shape_and_smoothing():
    img1 = build(ss=1).read_frame().astype(np.float32)
    img2 = build(ss=2).read_frame().astype(np.float32)
    assert img1.shape == img2.shape == (96, 96, 4)
    # SSAA splits one full-range edge step into smaller steps: the count of
    # EXTREME single-pixel jumps must drop
    def hard_edges(img):
        g = np.abs(np.diff(img[..., :3].mean(-1), axis=0))
        return (g > 150).sum()
    assert hard_edges(img2) < hard_edges(img1)
    # same overall image content
    assert abs(img1.mean() - img2.mean()) < 2.0


def test_bloom_render_brightens_neighborhood():
    off = build(use_bloom=False).read_frame().astype(np.float32)
    on = build(use_bloom=True).read_frame().astype(np.float32)
    assert on[..., :3].mean() >= off[..., :3].mean()
