"""Uniform-instancing broadcast path of the corner stage (ops/corner.py):
with draw_stride set, the per-triangle draw-row gather is replaced by a
broadcast + minor-dim reshape — results must be bit-identical to the
gather path, end to end."""

import numpy as np
import jax
import jax.numpy as jnp

from trident.core.config import EngineConfig, RenderConfig
from trident.ecs.components import (
    MeshComponent, TextureComponent, TransformComponent,
)
from trident.ecs.registry import Registry
from trident.geometry.primitives import PrimitiveType
from trident.io.image import checkerboard
from trident.render.renderer import Renderer


def _grid_renderer(n=3):
    r = Renderer(EngineConfig(render=RenderConfig(width=96, height=96)))
    reg = Registry()
    r.set_active_registry(reg)
    slot = r.acquire_texture("checker", checkerboard(32, 4))
    mesh_idx = r.ensure_primitive(PrimitiveType.SPHERE)
    for i in range(n):
        for j in range(n):
            e = reg.create()
            t = reg.add(e, TransformComponent())
            t.position = np.array([(i - n / 2) * 1.4, (j - n / 2) * 1.4, 0],
                                  np.float32)
            reg.add(e, MeshComponent(mesh_index=mesh_idx))
            reg.add(e, TextureComponent(path="checker", slot=slot))
    r.editor_camera.set_position([0, 0, n * 1.1 + 2])
    r.editor_camera.look_at_target([0, 0, 0])
    return r, reg


def test_corner_stage_broadcast_matches_gather():
    from trident.ecs.components import TransformComponent as TC
    from trident.ops.corner import build_draw_rows, corner_stage
    from trident.render.frame import (
        build_draw_params, gather_mesh_draws,
    )

    r, reg = _grid_renderer()
    packed = r.geometry.packed()
    records = gather_mesh_draws(reg, r.geometry)
    plan, tri_draw = r._plan_cache.plan(packed, records, r.geometry.version)
    stride = r._plan_cache.draw_stride
    nd = r._plan_cache.real_draws
    assert stride > 0 and nd == len(records)
    params, palette, shade = build_draw_params(
        records, plan.num_draws, material_table=r.geometry.material_table())
    corner_t = r._plan_cache.corner_table(packed)
    cam = r.editor_camera.params()
    rows = build_draw_rows(params, cam, 96, 96)

    ref = corner_stage(corner_t, rows, tri_draw, plan.tri_valid, 96, 96)
    fast = corner_stage(corner_t, rows, tri_draw, plan.tri_valid, 96, 96,
                        draw_stride=stride, real_draws=nd)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(fast)):
        if a is None:
            assert b is None
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_render_frame_broadcast_matches_gather():
    from trident.render.frame import (
        build_draw_params, gather_mesh_draws, geometry_to_device,
    )
    from trident.render.lights import gather_lights
    from trident.render.renderer import render_frame
    from trident.render.types import AiBlend, SkyboxCube

    r, reg = _grid_renderer()
    packed = r.geometry.packed()
    records = gather_mesh_draws(reg, r.geometry)
    plan, tri_draw = r._plan_cache.plan(packed, records, r.geometry.version)
    stride, nd = r._plan_cache.draw_stride, r._plan_cache.real_draws
    params, palette, shade = build_draw_params(
        records, plan.num_draws, material_table=r.geometry.material_table())
    geo = geometry_to_device(packed)
    corner_t = r._plan_cache.corner_table(packed)
    sky = SkyboxCube(faces=jnp.zeros((6, 1, 1, 3), jnp.float32),
                     valid=jnp.asarray(False))
    ai = AiBlend(image=jnp.zeros((1, 1, 3), jnp.float32),
                 blend=jnp.asarray(0.0, jnp.float32))
    common = dict(width=96, height=96, clear_color=(0.1, 0.1, 0.1, 1.0),
                  raster="pallas", chunk=64, skinned=False)
    base = render_frame(geo, plan, tri_draw, params, palette, shade,
                        r.editor_camera.params(), gather_lights(reg),
                        r.textures.device_arrays(), sky, ai,
                        corner_t=corner_t, **common)
    fast = render_frame(geo, plan, tri_draw, params, palette, shade,
                        r.editor_camera.params(), gather_lights(reg),
                        r.textures.device_arrays(), sky, ai,
                        corner_t=corner_t, draw_stride=stride,
                        real_draws=nd, **common)
    np.testing.assert_array_equal(np.asarray(base.color),
                                  np.asarray(fast.color))
    np.testing.assert_array_equal(np.asarray(base.tri_id),
                                  np.asarray(fast.tri_id))
