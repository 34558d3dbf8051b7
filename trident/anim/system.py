"""ECS AnimationSystem: drives AnimationComponents each runtime frame.

Reference: ECS/AnimationSystem.h + ECS/Components/AnimationSystem.cpp —
per entity: refresh cached handles when asset ids change, drive the state
machine if present else a clip player, write the pose into
AnimationComponent.bone_matrices (consumed by the renderer's bone palette).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from trident.anim.player import AnimationPlayer
from trident.anim.service import AnimationAssetService
from trident.ecs.components import AnimationComponent
from trident.ecs.registry import Registry


class AnimationSystem:
    _players: Dict[int, AnimationPlayer] = {}
    _samplers: "OrderedDict[tuple, object]" = None  # LRU, see _sampler_for
    _SAMPLER_CAP = 32     # baked device keyframe tables per live cache
                          # entry — bound it so load/unload cycles don't
                          # pin every clip ever seen (each entry also
                          # strong-refs its skeleton/clip)

    @classmethod
    def _player_for(cls, entity: int, anim: AnimationComponent) -> Optional[AnimationPlayer]:
        service = AnimationAssetService.get()
        skeleton = service.acquire_skeleton(anim.skeleton_asset)
        if skeleton is None:
            return None
        player = cls._players.get(entity)
        if player is None or player.skeleton is not skeleton:
            player = AnimationPlayer(skeleton)
            cls._players[entity] = player
        clips = service.acquire_animation_library(anim.animation_asset or anim.skeleton_asset)
        clip_idx = anim.clip_index
        if anim.clip_name:
            named = service.resolve_clip_index(
                anim.animation_asset or anim.skeleton_asset, anim.clip_name)
            if named >= 0:
                clip_idx = named
        if 0 <= clip_idx < len(clips) and player.clip is not clips[clip_idx]:
            player.set_clip(clips[clip_idx], reset_time=False)
        return player

    @classmethod
    def initialise_pose(cls, registry: Registry) -> None:
        """Emit bind/first poses on Play so skinned meshes never render
        un-posed (reference InitialisePose)."""
        for entity, (anim,) in registry.view(AnimationComponent):
            if anim.state_machine is not None:
                anim.bone_matrices = np.asarray(anim.state_machine.update(0.0))
                continue
            player = cls._player_for(entity, anim)
            if player is not None:
                anim.bone_matrices = player.evaluate_at(anim.time).copy()

    @classmethod
    def _sampler_for(cls, skeleton, clip):
        from collections import OrderedDict

        from trident.anim.batch import BatchedClipSampler

        if cls._samplers is None:
            cls._samplers = OrderedDict()
        # identity keys are safe here BECAUSE entries strong-ref their
        # skeleton/clip (live keys can't be id-recycled); the LRU cap is
        # what lets dead assets actually be released
        key = (id(skeleton), id(clip))
        sampler = cls._samplers.get(key)
        if sampler is None or sampler.skeleton is not skeleton \
                or sampler.clip is not clip:
            sampler = BatchedClipSampler(clip, skeleton)
            cls._samplers[key] = sampler
        cls._samplers.move_to_end(key)
        while len(cls._samplers) > cls._SAMPLER_CAP:
            cls._samplers.popitem(last=False)
        return sampler

    @classmethod
    def update(cls, registry: Registry, dt: float) -> None:
        """Advance every playing AnimationComponent. Clip-driven entities
        are grouped by (skeleton, clip) and pose-sampled in ONE jitted
        call per group (anim/batch.py) — time advance / loop policy stays
        per-entity host state; only the state-machine path walks entities
        individually (reference: AnimationSystem.cpp:120-165 is a
        per-entity loop for everything)."""
        groups: Dict[tuple, list] = {}
        for entity, (anim,) in registry.view(AnimationComponent):
            if not anim.playing:
                continue
            if anim.state_machine is not None:
                anim.bone_matrices = np.asarray(anim.state_machine.update(dt))
                anim.time += dt * anim.speed
                continue
            player = cls._player_for(entity, anim)
            if player is None:
                continue
            player.speed = anim.speed
            player.looping = anim.looping
            player.playing = True
            if player.clip is None:
                player.time = anim.time
                anim.bone_matrices = player.update(dt).copy()
                anim.time = player.time
                continue
            player.time = player._wrap(anim.time + dt * anim.speed)
            anim.time = player.time
            key = (id(player.skeleton), id(player.clip))
            groups.setdefault(key, []).append((anim, player))
        # the LRU cap must exceed the LIVE group count or every frame
        # evicts-and-rebuilds all samplers in rotation (a full host table
        # bake + XLA compile per group per frame); grow it to fit — the
        # cap still bounds dead load/unload-cycle assets
        if len(groups) + 8 > cls._SAMPLER_CAP:
            cls._SAMPLER_CAP = len(groups) + 8
        for items in groups.values():
            _, player0 = items[0]
            sampler = cls._sampler_for(player0.skeleton, player0.clip)
            palettes = sampler(np.asarray([a.time for a, _ in items]))
            for (anim, player), pal in zip(items, palettes):
                pal = np.ascontiguousarray(pal)
                anim.bone_matrices = pal
                player._palette = pal
        # players are keyed by entity id: prune entries whose entity no
        # longer carries an AnimationComponent so destroy/re-spawn cycles
        # don't pin skeletons and palettes forever
        if len(cls._players) > 4 * max(len(groups), 1) + 64:
            live = {e for e, _ in registry.view(AnimationComponent)}
            cls._players = {e: p for e, p in cls._players.items()
                            if e in live}
