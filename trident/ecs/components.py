"""Component structs (reference: ECS/Components/*.h — all ten).

Plain dataclasses with numpy fields; the renderer packs these into draw
arrays per frame, so components stay host-side and mutation-friendly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional

import numpy as np

from trident.geometry.primitives import PrimitiveType


def _vec3(x=0.0, y=0.0, z=0.0):
    return np.array([x, y, z], dtype=np.float32)


@dataclass
class TransformComponent:
    position: np.ndarray = field(default_factory=lambda: _vec3())
    rotation: np.ndarray = field(default_factory=lambda: _vec3())  # euler degrees
    scale: np.ndarray = field(default_factory=lambda: _vec3(1.0, 1.0, 1.0))

    def copy(self) -> "TransformComponent":
        return TransformComponent(self.position.copy(), self.rotation.copy(), self.scale.copy())


@dataclass
class MeshComponent:
    mesh_index: int = -1
    material_index: int = 0
    visible: bool = True
    primitive: PrimitiveType = PrimitiveType.NONE
    source_asset_path: str = ""     # for scene reload re-import
    source_mesh_index: int = -1
    tint: np.ndarray = field(default_factory=lambda: np.ones(4, dtype=np.float32))

    def copy(self) -> "MeshComponent":
        c = MeshComponent(self.mesh_index, self.material_index, self.visible,
                          self.primitive, self.source_asset_path, self.source_mesh_index)
        c.tint = self.tint.copy()
        return c


class ProjectionType(Enum):
    PERSPECTIVE = 0
    ORTHOGRAPHIC = 1


@dataclass
class CameraComponent:
    projection: ProjectionType = ProjectionType.PERSPECTIVE
    fov_deg: float = 45.0
    ortho_size: float = 10.0
    near_clip: float = 0.1
    far_clip: float = 1000.0
    primary: bool = False
    fixed_aspect: bool = False
    aspect: float = 16.0 / 9.0

    def copy(self) -> "CameraComponent":
        return CameraComponent(self.projection, self.fov_deg, self.ortho_size,
                               self.near_clip, self.far_clip, self.primary,
                               self.fixed_aspect, self.aspect)


class LightType(Enum):
    DIRECTIONAL = 0
    POINT = 1


@dataclass
class LightComponent:
    light_type: LightType = LightType.DIRECTIONAL
    color: np.ndarray = field(default_factory=lambda: _vec3(1.0, 1.0, 1.0))
    intensity: float = 1.0
    direction: np.ndarray = field(default_factory=lambda: _vec3(0.0, -1.0, 0.0))
    range: float = 10.0
    enabled: bool = True
    cast_shadows: bool = False

    def copy(self) -> "LightComponent":
        return LightComponent(self.light_type, self.color.copy(), self.intensity,
                              self.direction.copy(), self.range, self.enabled,
                              self.cast_shadows)


@dataclass
class SpriteComponent:
    texture_path: str = ""
    texture_slot: int = 0
    tint: np.ndarray = field(default_factory=lambda: np.ones(4, dtype=np.float32))
    uv_scale: np.ndarray = field(default_factory=lambda: np.ones(2, dtype=np.float32))
    uv_offset: np.ndarray = field(default_factory=lambda: np.zeros(2, dtype=np.float32))
    tiling: float = 1.0
    atlas_tiles: int = 1
    atlas_index: int = 0
    animation_speed: float = 0.0
    sort_offset: float = 0.0
    visible: bool = True

    def copy(self) -> "SpriteComponent":
        c = SpriteComponent(self.texture_path, self.texture_slot)
        c.tint = self.tint.copy()
        c.uv_scale = self.uv_scale.copy()
        c.uv_offset = self.uv_offset.copy()
        c.tiling = self.tiling
        c.atlas_tiles = self.atlas_tiles
        c.atlas_index = self.atlas_index
        c.animation_speed = self.animation_speed
        c.sort_offset = self.sort_offset
        c.visible = self.visible
        return c


@dataclass
class TextureComponent:
    path: str = ""
    slot: int = 0
    dirty: bool = True
    uv_scale: np.ndarray = field(default_factory=lambda: np.ones(2, dtype=np.float32))
    uv_offset: np.ndarray = field(default_factory=lambda: np.zeros(2, dtype=np.float32))
    tiling: float = 1.0

    def copy(self) -> "TextureComponent":
        c = TextureComponent(self.path, self.slot, self.dirty)
        c.uv_scale = self.uv_scale.copy()
        c.uv_offset = self.uv_offset.copy()
        c.tiling = self.tiling
        return c


@dataclass
class TagComponent:
    tag: str = "Entity"

    def copy(self) -> "TagComponent":
        return TagComponent(self.tag)


@dataclass
class UUIDComponent:
    uuid: int = 0

    def copy(self) -> "UUIDComponent":
        return UUIDComponent(self.uuid)


@dataclass
class ScriptComponent:
    """Script hook. The reference marks this 'PLANNED BUT NOT WORKED UPON'
    (ScriptComponent.h:15); here `module` may name a python callable
    `module:function(entity, registry, dt)` invoked during Scene.update."""

    path: str = ""
    autostart: bool = False
    running: bool = False
    module: str = ""

    def copy(self) -> "ScriptComponent":
        return ScriptComponent(self.path, self.autostart, self.running, self.module)


@dataclass
class AnimationComponent:
    """Skeletal animation state (reference: AnimationComponent.h:30-100)."""

    skeleton_asset: str = ""
    animation_asset: str = ""
    clip_index: int = 0
    clip_name: str = ""
    time: float = 0.0
    speed: float = 1.0
    looping: bool = True
    playing: bool = False
    bone_matrices: Optional[np.ndarray] = None   # (B,4,4) pose cache
    state_machine: Optional[object] = None       # anim.state_machine.StateMachineInstance
    bone_palette_offset: int = -1                # slot in the packed palette SSBO analogue

    def copy(self) -> "AnimationComponent":
        c = AnimationComponent(self.skeleton_asset, self.animation_asset,
                               self.clip_index, self.clip_name, self.time,
                               self.speed, self.looping, self.playing)
        c.bone_matrices = None if self.bone_matrices is None else self.bone_matrices.copy()
        sm = self.state_machine
        c.state_machine = sm.copy() if sm is not None and hasattr(sm, "copy") else sm
        return c


ALL_COMPONENT_TYPES = (
    TransformComponent, MeshComponent, CameraComponent, LightComponent,
    SpriteComponent, TextureComponent, TagComponent, UUIDComponent,
    ScriptComponent, AnimationComponent,
)
