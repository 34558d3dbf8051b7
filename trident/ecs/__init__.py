from trident.ecs.registry import Registry, Entity
from trident.ecs.components import (
    TransformComponent,
    MeshComponent,
    CameraComponent,
    LightComponent,
    SpriteComponent,
    TextureComponent,
    TagComponent,
    UUIDComponent,
    ScriptComponent,
    AnimationComponent,
    LightType,
    ProjectionType,
)

__all__ = [
    "Registry", "Entity",
    "TransformComponent", "MeshComponent", "CameraComponent", "LightComponent",
    "SpriteComponent", "TextureComponent", "TagComponent", "UUIDComponent",
    "ScriptComponent", "AnimationComponent", "LightType", "ProjectionType",
]
