"""Batched clip sampling (anim/batch.py): parity with the per-entity
player and O(1) dispatches for many instances of one (skeleton, clip)."""

import numpy as np

from trident.anim import batch as batch_mod
from trident.anim.batch import BatchedClipSampler
from trident.anim.data import AnimationClip, Bone, Skeleton, TransformChannel
from trident.anim.player import AnimationPlayer
from trident.anim.service import AnimationAssetService
from trident.anim.system import AnimationSystem
from trident.ecs.components import AnimationComponent
from trident.ecs.registry import Registry
from trident.mathx.quat import quat_from_euler_deg


def chain_skeleton(n=5):
    """Root → chain of children, each offset 1 unit along +x."""
    sk = Skeleton(name="chain")
    sk.add_bone(Bone(name="b0", source_name="b0"))
    for i in range(1, n):
        b = Bone(name=f"b{i}", source_name=f"b{i}", parent=i - 1)
        b.local_bind[0, 3] = 1.0
        b.inverse_bind[0, 3] = -float(i)
        sk.add_bone(b)
    return sk


def busy_clip(duration=2.0):
    """Mixed tracks: bone 0 translates (3 keys), bone 1 rotates (4 keys),
    bone 2 scales (2 keys), bone 3 has position AND rotation with different
    key counts, bone 4 has no channel at all."""
    def q(deg):
        return np.asarray(quat_from_euler_deg(
            np.array([0.0, 0.0, deg], np.float32)), np.float32)

    chans = [
        TransformChannel(
            bone_name="b0",
            position_times=np.array([0.0, 0.7, duration], np.float32),
            positions=np.array([[0, 0, 0], [1, 2, 0], [0, 4, 0]], np.float32)),
        TransformChannel(
            bone_name="b1",
            rotation_times=np.array([0.0, 0.5, 1.2, duration], np.float32),
            rotations=np.stack([q(0), q(45), q(120), q(200)])),
        TransformChannel(
            bone_name="b2",
            scale_times=np.array([0.0, duration], np.float32),
            scales=np.array([[1, 1, 1], [2, 0.5, 1.5]], np.float32)),
        TransformChannel(
            bone_name="b3",
            position_times=np.array([0.0, duration], np.float32),
            positions=np.array([[0, 0, 0], [0, 0, 3]], np.float32),
            rotation_times=np.array([0.0, 1.0, duration], np.float32),
            rotations=np.stack([q(0), q(-30), q(60)])),
    ]
    return AnimationClip(name="busy", duration=duration, channels=chans)


def test_batched_matches_per_entity_player(rng):
    sk = chain_skeleton(5)
    clip = busy_clip()
    sampler = BatchedClipSampler(clip, sk)
    player = AnimationPlayer(sk)
    player.set_clip(clip)
    # the sampler takes PRE-wrapped times (loop policy is host state);
    # clamp mode makes player.evaluate_at the identity on [0, duration]
    player.looping = False

    # include exact key times, 0, the duration, and beyond-key extremes
    times = np.concatenate([
        rng.uniform(0.0, clip.duration, 57).astype(np.float32),
        np.array([0.0, 0.5, 0.7, 1.2, clip.duration], np.float32),
    ])
    batched = sampler(times)
    assert batched.shape == (len(times), 5, 4, 4)
    for t, pal in zip(times, batched):
        expect = player.evaluate_at(float(t))
        np.testing.assert_allclose(pal, expect, atol=3e-5,
                                   err_msg=f"t={t}")


def test_system_uses_one_dispatch_per_group(monkeypatch):
    """64 instances of one (skeleton, clip) → ONE sampler call per frame,
    palettes identical to the per-entity player."""
    sk = chain_skeleton(4)
    clip = busy_clip()
    service = AnimationAssetService.get()
    service.register_runtime_asset("batch_asset", sk, [clip])

    reg = Registry()
    n = 64
    entities = []
    for i in range(n):
        e = reg.create()
        anim = reg.add(e, AnimationComponent(skeleton_asset="batch_asset"))
        anim.playing = True
        anim.speed = 0.5 + 0.01 * i     # distinct per-entity times
        entities.append(e)

    calls = []
    orig = BatchedClipSampler.__call__

    def counted(self, times):
        calls.append(len(times))
        return orig(self, times)

    monkeypatch.setattr(BatchedClipSampler, "__call__", counted)
    AnimationSystem.update(reg, 0.25)
    AnimationSystem.update(reg, 0.25)
    assert len(calls) == 2 and all(c == n for c in calls)

    player = AnimationPlayer(sk)
    player.set_clip(clip)
    for e in entities:
        anim = reg.get(e, AnimationComponent)
        np.testing.assert_allclose(anim.time, 0.5 * anim.speed, atol=1e-6)
        expect = player.evaluate_at(anim.time)
        np.testing.assert_allclose(anim.bone_matrices, expect, atol=3e-5)


def test_instance_count_bucketing_no_retrace():
    """Adding one instance must not retrace: N pads to pow2 buckets. The
    jitted sampler is MODULE-level so equal-shape samplers (and rebuilt
    LRU evictees) share one compiled executable."""
    from trident.anim import batch as batch_mod

    sk = chain_skeleton(3)
    clip = busy_clip()
    sampler = BatchedClipSampler(clip, sk)
    out5 = sampler(np.linspace(0, 1, 5).astype(np.float32))
    assert out5.shape[0] == 5
    fn = batch_mod._sample_palettes_jit
    traces = fn._cache_size() if hasattr(fn, "_cache_size") else None
    out7 = sampler(np.linspace(0, 1, 7).astype(np.float32))
    assert out7.shape[0] == 7
    if traces is not None:
        assert fn._cache_size() == traces  # same pow2 bucket (8)
        # a second sampler with identical table shapes also reuses it
        sampler2 = BatchedClipSampler(busy_clip(), chain_skeleton(3))
        out2 = sampler2(np.linspace(0, 1, 6).astype(np.float32))
        assert out2.shape[0] == 6
        assert fn._cache_size() == traces
