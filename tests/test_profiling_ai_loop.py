"""Profiling hooks + AI interpolation blended into the live frame loop."""

import numpy as np
import pytest

import jax


def test_compilation_stats_counts_variants():
    from trident.core.config import EngineConfig, RenderConfig
    from trident.ecs.components import MeshComponent, TransformComponent
    from trident.ecs.registry import Registry
    from trident.geometry.primitives import PrimitiveType
    from trident.render.renderer import Renderer
    from trident.utils import compilation_stats

    r = Renderer(EngineConfig(render=RenderConfig(width=32, height=32,
                                                  use_pallas=False)))
    reg = Registry()
    r.set_active_registry(reg)
    e = reg.create()
    reg.add(e, TransformComponent())
    reg.add(e, MeshComponent(mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
    before = compilation_stats().render_frame_variants
    r.render_viewport(0)
    mid = compilation_stats().render_frame_variants
    assert mid >= before
    r.render_viewport(0)  # same shapes → no retrace
    assert compilation_stats().render_frame_variants == mid
    r.set_viewport(1, 48, 32)
    r.render_viewport(1)  # new size → one more variant
    assert compilation_stats().render_frame_variants == mid + 1


def test_profiler_noop_safe(tmp_path):
    from trident.utils import Profiler, profile_block

    p = Profiler(str(tmp_path / "traces"))
    started = p.start()
    with profile_block("test-block"):
        _x = jax.numpy.ones(8) * 2
    if started:
        assert p.stop() is not None
    else:
        assert p.stop() is None


def test_ai_blend_in_app_loop():
    """Frame interpolation feeds back into rendering through the app loop."""
    from trident.ai.model import init_model
    from trident.app import Application
    from trident.core.config import AiConfig, EngineConfig, RenderConfig
    from trident.ecs.components import MeshComponent, TransformComponent
    from trident.geometry.primitives import PrimitiveType

    cfg = EngineConfig(
        render=RenderConfig(width=48, height=48, use_pallas=False),
        ai=AiConfig(enabled=True, blend=0.9, net_resolution=(16, 16),
                    cadence_ms=0.0))
    app = Application(cfg)
    model, variables = init_model(jax.random.PRNGKey(0), (16, 16), base_channels=4)
    assert app.frame_generator.initialise(model=model, variables=variables)

    reg = app.scene.editor_registry
    e = reg.create()
    reg.add(e, TransformComponent())
    reg.add(e, MeshComponent(
        mesh_index=app.renderer.ensure_primitive(PrimitiveType.CUBE)))
    app.renderer.editor_camera.set_position([0, 0, 3])
    app.renderer.editor_camera.look_at_target([0, 0, 0])

    import time

    baseline = None
    blended = False
    # generous budget: the interpolation worker is a plain thread and can
    # be starved for seconds when the machine is busy (observed flaking at
    # 1.5 s while a benchmark ran concurrently)
    for k in range(100):
        app.update()
        out = app.render()
        frame = app.renderer.read_frame(out)
        if baseline is None:
            baseline = frame
        if app.renderer.ai_blend > 0:
            blended = True
            break
        time.sleep(0.1)
    assert blended, "AI output never consumed into the render loop"
    # with blend wired, the next rendered frame differs from pure raster
    app.renderer.config.render  # keep
    pure = app.renderer.set_ai_frame(None, 0.0) or app.renderer.read_frame()
    app.shutdown()
