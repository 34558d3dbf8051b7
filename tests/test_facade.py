"""RenderCommand facade, allocation telemetry, checkpoint validation."""

import numpy as np
import pytest

from trident.core.alloc import AllocationTracker, device_memory_stats
from trident.core.config import EngineConfig, RenderConfig


def test_render_command_facade(tmp_path):
    from trident.ecs.components import MeshComponent, TransformComponent
    from trident.geometry.primitives import PrimitiveType
    from trident.render.command import RenderCommand as RC

    RC.init(EngineConfig(render=RenderConfig(width=64, height=64,
                                             use_pallas=False)))
    try:
        reg = RC.get_registry()
        e = reg.create()
        reg.add(e, TransformComponent())
        reg.add(e, MeshComponent(
            mesh_index=RC.renderer().ensure_primitive(PrimitiveType.CUBE)))
        RC.set_editor_camera([0, 0, 3], target=[0, 0, 0])
        RC.queue_text(0, "hi", 2, 2)
        RC.begin_performance_capture()
        out = RC.draw_frame()
        img = RC.get_viewport_texture(0)
        assert img.shape == (64, 64, 4)
        csv = RC.end_performance_capture()
        assert csv is None or csv.endswith(".csv")
        stats = RC.get_frame_timing_stats()
        assert stats.sample_count >= 1

        # gizmo write: move the cube via a world matrix
        m = RC.get_world_transform(e)
        m[0, 3] = 2.5
        RC.set_world_transform(e, m)
        t = reg.get(e, TransformComponent)
        assert t.position[0] == pytest.approx(2.5, abs=1e-4)

        assert RC.get_ai_debug_stats().enabled is False
        RC.set_ai_blend_strength(0.4)
        assert RC.app().config.ai.blend == 0.4
    finally:
        RC.shutdown()


def test_allocation_tracker():
    tracker = AllocationTracker(track_host=True)
    tracker.begin_frame()
    _garbage = [bytearray(1000) for _ in range(100)]
    tracker.end_frame()
    stats = tracker.stats()
    assert stats.host_bytes != 0 or stats.host_allocs >= 0
    # device stats shouldn't raise regardless of backend
    in_use, peak = device_memory_stats()
    assert in_use >= 0 and peak >= 0


def test_checkpoint_validation(tmp_path):
    import jax
    from trident.ai.train import TrainConfig, create_state, save_checkpoint
    from trident.ai.validate import validate_checkpoint

    bad = validate_checkpoint(str(tmp_path / "nope"))
    assert not bad.ok and "not found" in bad.message

    cfg = TrainConfig(resolution=(16, 16), base_channels=4,
                      checkpoint_dir=str(tmp_path / "ckpt"))
    state = create_state(cfg)
    import os
    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    save_checkpoint(state, cfg.checkpoint_dir, 0)
    good = validate_checkpoint(cfg.checkpoint_dir, (16, 16), 4)
    assert good.ok, good.message
    # wrong architecture must fail loudly
    mismatch = validate_checkpoint(cfg.checkpoint_dir, (16, 16), 8)
    assert not mismatch.ok


def test_entity_picking():
    import numpy as np
    from trident.ecs.components import MeshComponent, TransformComponent
    from trident.ecs.registry import Registry
    from trident.geometry.primitives import PrimitiveType
    from trident.render.renderer import Renderer

    r = Renderer(EngineConfig(render=RenderConfig(width=96, height=96,
                                                  use_pallas=False)))
    reg = Registry()
    r.set_active_registry(reg)
    left = reg.create()
    tl = reg.add(left, TransformComponent())
    tl.position = np.array([-0.8, 0, 0], np.float32)
    reg.add(left, MeshComponent(mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
    right = reg.create()
    tr_ = reg.add(right, TransformComponent())
    tr_.position = np.array([0.8, 0, 0], np.float32)
    reg.add(right, MeshComponent(mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
    r.editor_camera.set_position([0, 0, 4])
    r.editor_camera.look_at_target([0, 0, 0])
    r.render_viewport(0)
    assert r.pick(24, 48) == left      # left third of the screen
    assert r.pick(72, 48) == right
    assert r.pick(48, 4) == -1         # sky
    assert r.pick(-5, 10) == -1        # out of bounds
