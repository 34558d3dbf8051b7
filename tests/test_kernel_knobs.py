"""Upscaler knob registry (ops/kernel_knobs.py, SURVEY §5): knobs are
settable per run, typos and bad values fail loudly, and renderers with
different knob sets keep separate traces in one process."""

import sys

import numpy as np
import pytest

from trident.ai import upscaler
from trident.ops import kernel_knobs


def test_snapshot_apply_restore_roundtrip():
    before = kernel_knobs.snapshot()
    prev = kernel_knobs.apply({"d2s_mode": "pad", "upscale_dtype": "f32"})
    try:
        assert upscaler.D2S_MODE == "pad"
        assert upscaler.UPSCALE_DTYPE == "f32"
        assert kernel_knobs.trace_key() != tuple(sorted(before.items()))
    finally:
        kernel_knobs.apply(prev)
    assert kernel_knobs.snapshot() == before


def test_unknown_and_invalid_knobs_fail_loudly():
    with pytest.raises(KeyError):
        kernel_knobs.apply({"d2s_mdoe": "pad"})  # typo must not silently noop
    before = kernel_knobs.snapshot()
    with pytest.raises(ValueError):
        kernel_knobs.apply({"d2s_mode": "bogus"})
    assert kernel_knobs.snapshot() == before     # all-or-nothing rollback


def test_overrides_context_manager():
    base = upscaler.D2S_MODE
    with kernel_knobs.overrides(d2s_mode="xla"):
        assert upscaler.D2S_MODE == "xla"
    assert upscaler.D2S_MODE == base


def _ai_renderer(kernel):
    from trident.core.config import EngineConfig, RenderConfig
    from trident.ecs import (
        MeshComponent, Registry, TextureComponent, TransformComponent,
    )
    from trident.geometry.primitives import PrimitiveType
    from trident.io.image import checkerboard
    from trident.render.renderer import Renderer

    r = Renderer(EngineConfig(render=RenderConfig(
        width=64, height=64, ai_upscale=True, kernel=kernel)))
    reg = Registry()
    r.set_active_registry(reg)
    slot = r.acquire_texture("checker", checkerboard(32, 4))
    e = reg.create()
    t = reg.add(e, TransformComponent())
    t.rotation = np.array([20.0, 35.0, 0.0], np.float32)
    reg.add(e, MeshComponent(mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
    reg.add(e, TextureComponent(path="checker", slot=slot))
    r.editor_camera.set_position([0, 0.6, 3.0])
    r.editor_camera.look_at_target([0, 0, 0])
    return r


def test_two_kernel_configs_in_one_process():
    """Two renderers with different knob sets render interleaved in one
    process; the depth-to-space modes are bit-exact relayouts, so both
    images are identical while their traces stay separate."""
    base = kernel_knobs.snapshot()
    try:
        ra = _ai_renderer({"d2s_mode": "pad"})
        rb = _ai_renderer({"d2s_mode": "xla"})
        fa1 = np.asarray(ra.read_frame())
        fb1 = np.asarray(rb.read_frame())
        fa2 = np.asarray(ra.read_frame())   # interleave back to A
        np.testing.assert_array_equal(fa1, fb1)
        np.testing.assert_array_equal(fa1, fa2)
        assert ra._kcfg != rb._kcfg
    finally:
        kernel_knobs.apply(base)


def test_renderer_without_ai_has_no_knob_key():
    """Without an AI feature a renderer keys no knobs (and needs no ai
    package); with one it keys the env-default baseline plus its own
    overrides."""
    from trident.core.config import EngineConfig, RenderConfig
    from trident.render.renderer import Renderer

    base = kernel_knobs.snapshot()
    try:
        plain = Renderer(EngineConfig(render=RenderConfig(width=32,
                                                          height=32)))
        assert plain._kcfg is None
        ro = Renderer(EngineConfig(render=RenderConfig(
            width=32, height=32, ai_upscale=True,
            kernel={"upscale_dtype": "f32"})))
        assert dict(ro._kcfg)["upscale_dtype"] == "f32"
    finally:
        kernel_knobs.apply(base)


def test_default_renderer_resets_leaked_globals():
    """An AI renderer with no overrides constructed after a sweep leaked
    knob overrides must snapshot the env-default baseline, not the leaked
    globals (advisor round-4 finding)."""
    from trident.core.config import EngineConfig, RenderConfig
    from trident.render.renderer import Renderer

    base = kernel_knobs.snapshot()
    try:
        kernel_knobs.apply({"d2s_mode": "pad"})        # leaked sweep
        rd = Renderer(EngineConfig(render=RenderConfig(
            width=32, height=32, ai_upscale=True)))
        env = kernel_knobs.env_defaults()
        assert dict(rd._kcfg)["d2s_mode"] == env["d2s_mode"]
        assert upscaler.D2S_MODE == env["d2s_mode"]
    finally:
        kernel_knobs.apply(base)
