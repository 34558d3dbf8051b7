from trident.render.types import (
    CameraParams,
    LightParams,
    DrawParams,
    DrawPlan,
    GeometryBuffers,
    FrameOutput,
)
from trident.render.camera import Camera, EditorCamera, RuntimeCamera

__all__ = [
    "CameraParams", "LightParams", "DrawParams", "DrawPlan",
    "GeometryBuffers", "FrameOutput",
    "Camera", "EditorCamera", "RuntimeCamera",
]
