"""Gather LightComponents into LightParams.

Semantics match Renderer::UpdateUniformBuffer (Renderer.cpp:5845-5915):
  * ambient (0.03, 0.03, 0.03) × 1.0 default
  * first enabled directional light wins; its direction must be non-tiny
  * up to 8 enabled point lights, position from the entity Transform
  * fallback warm sun dir(-0.5,-1,-0.3) color(1,0.98,0.92) ×5 ONLY when the
    scene has no enabled lights at all
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from trident.ecs.components import LightComponent, LightType, TransformComponent
from trident.ecs.registry import Registry
from trident.render.types import LightParams

DEFAULT_SUN_DIRECTION = np.array([-0.5, -1.0, -0.3], np.float32)
DEFAULT_SUN_COLOR = np.array([1.0, 0.98, 0.92], np.float32)
DEFAULT_SUN_INTENSITY = 5.0
DEFAULT_AMBIENT = np.array([0.03, 0.03, 0.03, 1.0], np.float32)
MAX_POINT_LIGHTS = 8


def gather_lights(registry: Registry,
                  ambient: np.ndarray = DEFAULT_AMBIENT) -> LightParams:
    """Pack lights. Point-light arrays are sized to a bucket of the actual
    count (0/2/4/8) — the shading loop is unrolled statically, so empty
    slots would otherwise burn ~60 VPU ops each per pixel."""
    dir_direction = DEFAULT_SUN_DIRECTION / np.linalg.norm(DEFAULT_SUN_DIRECTION)
    dir_color = DEFAULT_SUN_COLOR.copy()
    dir_intensity = DEFAULT_SUN_INTENSITY
    dir_count = 0

    point_pos_range = np.zeros((MAX_POINT_LIGHTS, 4), np.float32)
    point_color_intensity = np.zeros((MAX_POINT_LIGHTS, 4), np.float32)
    point_count = 0

    for entity, (light,) in registry.view(LightComponent):
        if not light.enabled:
            continue
        if light.light_type == LightType.DIRECTIONAL:
            if dir_count == 0:
                d = np.asarray(light.direction, np.float32)
                if float(d @ d) > 1e-4:
                    dir_direction = d / np.linalg.norm(d)
                dir_color = np.asarray(light.color, np.float32)
                dir_intensity = max(light.intensity, 0.0)
            dir_count += 1
        elif light.light_type == LightType.POINT and point_count < MAX_POINT_LIGHTS:
            transform = registry.try_get(entity, TransformComponent)
            pos = transform.position if transform is not None else np.zeros(3, np.float32)
            point_pos_range[point_count] = [*pos, max(light.range, 0.0)]
            point_color_intensity[point_count] = [*light.color, max(light.intensity, 0.0)]
            point_count += 1

    fallback = dir_count == 0 and point_count == 0
    dir_used = 1 if (dir_count > 0 or fallback) else 0

    bucket = 0 if point_count == 0 else (2 if point_count <= 2 else
                                         (4 if point_count <= 4 else MAX_POINT_LIGHTS))
    # numpy-backed (see render/bundle.py: frame state ships as one blob)
    return LightParams(
        ambient=np.asarray(ambient, np.float32),
        dir_direction=np.asarray(dir_direction, np.float32),
        dir_color=np.asarray([*dir_color, dir_intensity], np.float32),
        dir_count=np.int32(dir_used),
        point_pos_range=point_pos_range[:bucket].reshape(bucket, 4),
        point_color_intensity=point_color_intensity[:bucket].reshape(bucket, 4),
        point_count=np.int32(point_count),
    )
