"""Animation: clip sampling, player, blending, state machine, ECS system."""

import numpy as np
import pytest

from trident.anim.blend_tree import Blend2Node, BlendSample, BlendSpace1DNode, ClipNode
from trident.anim.data import AnimationClip, Bone, Skeleton, TransformChannel, normalize_bone_name
from trident.anim.player import AnimationPlayer
from trident.anim.pose import Pose, blend_pose, compose_skinning_matrices, sample_clip_pose
from trident.anim.service import AnimationAssetService
from trident.anim.state_machine import (
    AnimationStateMachine, Comparison, Condition, Layer, ParameterType, State, Transition,
)
from trident.anim.system import AnimationSystem
from trident.ecs.components import AnimationComponent, TransformComponent
from trident.ecs.registry import Registry
from trident.mathx.quat import quat_from_euler_deg


def two_bone_skeleton():
    sk = Skeleton(name="test")
    root = Bone(name="root", source_name="mixamorig:root")
    sk.add_bone(root)
    child = Bone(name="arm", source_name="mixamorig:arm", parent=0)
    child.local_bind[0, 3] = 2.0  # arm sits 2 units along +x from root
    # inverse bind = inverse of global bind
    child.inverse_bind[0, 3] = -2.0
    sk.add_bone(child)
    return sk


def translation_clip(duration=2.0):
    """Root translates 0 → (0,4,0) linearly over the clip."""
    ch = TransformChannel(
        bone_name="mixamorig:root",
        position_times=np.array([0.0, duration], np.float32),
        positions=np.array([[0, 0, 0], [0, 4, 0]], np.float32),
    )
    return AnimationClip(name="rise", duration=duration, channels=[ch])


def rotation_clip(duration=1.0):
    q0 = np.asarray(quat_from_euler_deg(np.array([0.0, 0.0, 0.0], np.float32)))
    q1 = np.asarray(quat_from_euler_deg(np.array([0.0, 0.0, 90.0], np.float32)))
    ch = TransformChannel(
        bone_name="root",
        rotation_times=np.array([0.0, duration], np.float32),
        rotations=np.stack([q0, q1]).astype(np.float32),
    )
    return AnimationClip(name="spin", duration=duration, channels=[ch])


def test_mixamo_normalization():
    assert normalize_bone_name("mixamorig:Hips") == "Hips"
    assert normalize_bone_name("Hips") == "Hips"


def test_sample_midpoint():
    sk = two_bone_skeleton()
    clip = translation_clip()
    pose = sample_clip_pose(clip, sk, 1.0)
    np.testing.assert_allclose(pose.position[0], [0, 2, 0], atol=1e-5)


def test_player_loop_and_palette():
    sk = two_bone_skeleton()
    player = AnimationPlayer(sk)
    player.set_clip(translation_clip(2.0))
    player.play()
    palette = player.update(1.0)  # t=1 → root at (0,2,0)
    # root skin matrix translates by (0,2,0)
    p = palette[0] @ np.array([0, 0, 0, 1.0])
    np.testing.assert_allclose(p[:3], [0, 2, 0], atol=1e-5)
    # child: global = root_global @ child_local(bind) ; skin = global @ inv_bind
    p2 = palette[1] @ np.array([2, 0, 0, 1.0])  # a point at the arm bind position
    np.testing.assert_allclose(p2[:3], [2, 2, 0], atol=1e-5)
    # looping: t = 1.0 + 2.0 wraps to 1.0
    player.update(2.0)
    np.testing.assert_allclose(player.time, 1.0, atol=1e-5)


def test_rotation_skinning():
    sk = two_bone_skeleton()
    player = AnimationPlayer(sk)
    player.set_clip(rotation_clip(1.0))
    player.playing = True
    player.looping = False  # t=1.0 must clamp to the end, not wrap to 0
    palette = player.update(1.0)  # 90° about z at root
    # arm joint (at (2,0,0) in bind) should move to (0,2,0)
    p = palette[1] @ np.array([2, 0, 0, 1.0])
    np.testing.assert_allclose(p[:3], [0, 2, 0], atol=1e-4)


def test_blend_pose_halfway():
    sk = two_bone_skeleton()
    a = sample_clip_pose(translation_clip(), sk, 0.0)
    b = sample_clip_pose(translation_clip(), sk, 2.0)
    mid = blend_pose(a, b, 0.5)
    np.testing.assert_allclose(mid.position[0], [0, 2, 0], atol=1e-5)


def test_blend_mask():
    sk = two_bone_skeleton()
    a = sample_clip_pose(translation_clip(), sk, 0.0)
    b = sample_clip_pose(translation_clip(), sk, 2.0)
    mask = np.array([0.0, 1.0], np.float32)  # root masked out
    out = blend_pose(a, b, 1.0, mask)
    np.testing.assert_allclose(out.position[0], [0, 0, 0], atol=1e-5)


def test_blend_space_1d():
    sk = two_bone_skeleton()
    node = BlendSpace1DNode("speed", [
        BlendSample(0.0, ClipNode(translation_clip(), speed=0.0)),
        BlendSample(1.0, ClipNode(rotation_clip(), speed=0.0)),
    ])
    from trident.anim.blend_tree import EvalContext
    ctx = EvalContext(sk, {"speed": 0.0}, Pose.bind(sk))
    pose = node.evaluate(ctx, 0.0)
    np.testing.assert_allclose(pose.position[0], [0, 0, 0], atol=1e-5)


def test_state_machine_transition():
    sk = two_bone_skeleton()
    sm = AnimationStateMachine(sk)
    sm.add_parameter("go", ParameterType.TRIGGER)
    layer = sm.add_layer(Layer("base"))
    layer.add_state(State("idle", ClipNode(translation_clip(), speed=0.0)), default=True)
    layer.add_state(State("rise", ClipNode(translation_clip())))
    layer.add_transition(Transition("idle", "rise", [
        Condition("go", Comparison.TRIGGERED)], fade_duration=0.0))
    sm.update(0.1)
    assert layer.current == "idle"
    sm.set_trigger("go")
    sm.update(0.1)
    assert layer.current == "rise"
    # trigger consumed
    assert sm.parameters["go"] == 0.0


def test_animation_system_updates_component():
    sk = two_bone_skeleton()
    AnimationAssetService.reset()
    AnimationAssetService.get().register_runtime_asset(
        "rig", sk, [translation_clip(2.0)])
    reg = Registry()
    e = reg.create()
    reg.add(e, TransformComponent())
    reg.add(e, AnimationComponent(skeleton_asset="rig", animation_asset="rig",
                                  clip_index=0, playing=True))
    AnimationSystem.update(reg, 1.0)
    anim = reg.get(e, AnimationComponent)
    assert anim.bone_matrices is not None
    p = anim.bone_matrices[0] @ np.array([0, 0, 0, 1.0])
    np.testing.assert_allclose(p[:3], [0, 2, 0], atol=1e-5)
    assert anim.time == pytest.approx(1.0)


def test_asset_service_resolve_clip():
    AnimationAssetService.reset()
    svc = AnimationAssetService.get()
    sk = two_bone_skeleton()
    svc.register_runtime_asset("rig", sk, [translation_clip(), rotation_clip()])
    assert svc.resolve_clip_index("rig", "spin") == 1
    assert svc.resolve_clip_index("rig", "nope") == -1
