"""AnimationPlayer: deterministic clip sampler → skinning palette.

Reference: Animation/AnimationPlayer.{h,cpp} — advance time with loop/clamp,
keyframe interpolation (lerp vec3 / slerp quat), hierarchy walk, × inverse
bind into reusable scratch buffers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from trident.anim.data import AnimationClip, Skeleton
from trident.anim.pose import Pose, compose_skinning_matrices, sample_clip_pose


class AnimationPlayer:
    def __init__(self, skeleton: Skeleton) -> None:
        self.skeleton = skeleton
        self.clip: Optional[AnimationClip] = None
        self.time = 0.0
        self.speed = 1.0
        self.looping = True
        self.playing = False
        self._bind = Pose.bind(skeleton)
        self._palette = np.tile(np.eye(4, dtype=np.float32), (len(skeleton), 1, 1))

    def set_clip(self, clip: AnimationClip, reset_time: bool = True) -> None:
        self.clip = clip
        if reset_time:
            self.time = 0.0

    def play(self) -> None:
        self.playing = True

    def pause(self) -> None:
        self.playing = False

    def _wrap(self, t: float) -> float:
        if self.clip is None or self.clip.duration <= 0:
            return 0.0
        if self.looping:
            return float(np.mod(t, self.clip.duration))
        return float(np.clip(t, 0.0, self.clip.duration))

    def update(self, dt: float) -> np.ndarray:
        """Advance and return the (B,4,4) skinning palette."""
        if self.playing and self.clip is not None:
            self.time = self._wrap(self.time + dt * self.speed)
        return self.evaluate_at(self.time)

    def evaluate_at(self, time: float) -> np.ndarray:
        """Sample at an absolute time (seconds) without advancing state."""
        if self.clip is None:
            self._palette = compose_skinning_matrices(self._bind, self.skeleton)
            return self._palette
        pose = sample_clip_pose(self.clip, self.skeleton, self._wrap(time),
                                base=self._bind)
        self._palette = compose_skinning_matrices(pose, self.skeleton)
        return self._palette

    def copy_pose_to(self, out: np.ndarray) -> None:
        np.copyto(out, self._palette)

    @property
    def palette(self) -> np.ndarray:
        return self._palette
