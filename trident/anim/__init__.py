from trident.anim.data import Bone, Skeleton, AnimationClip, TransformChannel
from trident.anim.player import AnimationPlayer
from trident.anim.service import AnimationAssetService

__all__ = ["Bone", "Skeleton", "AnimationClip", "TransformChannel",
           "AnimationPlayer", "AnimationAssetService"]
