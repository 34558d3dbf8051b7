"""Application shell: the engine's frame loop + layer stack.

Reference: Application.{h,cpp} (Run = Update→Render), Layer/Layer.h
lifecycle, and the RenderCommand static facade (RenderCommand.h:14-83).
Headless by design: the "window" is the active viewport's framebuffer;
frontends (notebook, web viewer, CLI) subclass Layer and drive/consume it.
Every editor-facing RenderCommand capability is a method here.
"""

from __future__ import annotations

import time as _time
from typing import Callable, List, Optional

import numpy as np

from trident.core.config import EngineConfig
from trident.core.events import Event, EventDispatcher, FileDropEvent, WindowCloseEvent
from trident.core.filewatch import FileWatcher, ReloadStatus, ReloadType
from trident.core.input import Input
from trident.core.log import get_logger
from trident.core.timing import Time
from trident.ai.frame_generator import FrameGenerator
from trident.ecs.scene import Scene
from trident.io.dataset_recorder import FrameDatasetRecorder
from trident.io.video import VideoEncoder
from trident.render.renderer import Renderer

logger = get_logger("app")


class Layer:
    """Lifecycle hooks (reference: Layer/Layer.h)."""

    def initialize(self, app: "Application") -> None: ...
    def update(self, app: "Application", dt: float) -> None: ...
    def render(self, app: "Application") -> None: ...
    def on_event(self, app: "Application", event: Event) -> bool:
        return False
    def shutdown(self, app: "Application") -> None: ...


class Application:
    def __init__(self, config: Optional[EngineConfig] = None) -> None:
        self.config = EngineConfig.from_env(config)
        self.renderer = Renderer(self.config)
        self.scene = Scene(renderer=self.renderer)
        self.renderer.set_active_registry(self.scene.editor_registry)
        self.input = Input.get()
        self.time = Time()
        self.dispatcher = EventDispatcher()
        self.layers: List[Layer] = []
        self.running = False

        # aux subsystems
        self.file_watcher = FileWatcher()
        self.dataset_recorder = FrameDatasetRecorder(
            self.config.capture.dataset_dir, self.config.capture.dataset_interval_s)
        self.video_encoder = VideoEncoder()
        self.frame_generator = FrameGenerator(
            resolution=self.config.ai.net_resolution,
            base_channels=self.config.ai.base_channels)
        self._ai_last_submit = 0.0
        self._ai_job_to_dataset: dict = {}   # AI job index → dataset index
        if self.config.capture.dataset_enabled:
            self.dataset_recorder.start()
        if self.config.ai.enabled and self.config.ai.model_path:
            self.frame_generator.initialise(self.config.ai.model_path)
        for sub, kind in (("Shaders", ReloadType.SHADER),
                          ("Models", ReloadType.MODEL),
                          ("Textures", ReloadType.TEXTURE)):
            self.file_watcher.watch(f"{self.config.assets_root}/{sub}", kind)

    # -- layers ---------------------------------------------------------------------
    def push_layer(self, layer: Layer) -> None:
        self.layers.append(layer)
        layer.initialize(self)

    # -- events ---------------------------------------------------------------------
    def post_event(self, event: Event) -> None:
        self.input.on_event(event)
        for layer in reversed(self.layers):
            if event.handled:
                break
            if layer.on_event(self, event):
                event.handled = True
        self.dispatcher.dispatch(event)
        if isinstance(event, WindowCloseEvent):
            self.running = False
        elif isinstance(event, FileDropEvent):
            self.import_assets(event.paths)

    def import_assets(self, paths: List[str]) -> List[int]:
        from trident.assets.scene_loader import import_model_entities

        entities: List[int] = []
        for path in paths:
            try:
                entities.extend(import_model_entities(
                    path, self.scene.editor_registry, self.renderer))
            except Exception as exc:
                logger.warning("import failed for %s: %s", path, exc)
        return entities

    # -- reload (hot asset refresh; reference Renderer::ProcessReloadEvents) --------
    def process_reload_events(self) -> None:
        self.file_watcher.poll()
        while True:
            event = self.file_watcher.pop_pending()
            if event is None:
                break
            try:
                if event.kind == ReloadType.TEXTURE:
                    from trident.io.image import load_rgba8_mips

                    rgba, mips = load_rgba8_mips(event.path)
                    self.renderer.textures.replace(event.path, rgba,
                                                   mips=mips)
                    event.status = ReloadStatus.SUCCESS
                elif (event.kind == ReloadType.SHADER
                      and self.renderer.shader_hook.matches(event.path)):
                    # the active custom shading module changed on disk:
                    # re-import and retrace (Pipeline.cpp:997-1058's
                    # rebuild-on-GLSL-change); a broken edit keeps the
                    # previous shader live
                    ok = self.renderer.shader_hook.load(event.path)
                    event.status = (ReloadStatus.SUCCESS if ok
                                    else ReloadStatus.FAILED)
                elif event.kind == ReloadType.MODEL:
                    # re-import the changed model and patch the live
                    # geometry slots in place (reference re-imports and
                    # patches geometry/material slots, Renderer.cpp:
                    # 5739-5820). A model never imported this session has
                    # nothing to patch (no-op SUCCESS); a failed re-import
                    # keeps the old geometry (the except below → FAILED).
                    self.reload_model(event.path)
                    event.status = ReloadStatus.SUCCESS
                else:
                    event.status = ReloadStatus.SUCCESS
                if event.status == ReloadStatus.SUCCESS:
                    logger.info("hot-reloaded %s", event.path)
            except Exception as exc:
                event.status = ReloadStatus.FAILED
                logger.warning("hot reload failed for %s: %s", event.path, exc)

    def reload_model(self, path: str) -> bool:
        """Re-import a changed model file and patch its live geometry /
        material slots (the reference's model hot reload, Renderer.cpp:
        5739-5820 + 2118-2188). Existing MeshComponent indices stay valid;
        returns False when the path was never imported this session. Any
        loader error propagates so process_reload_events marks FAILED and
        the old geometry stays live."""
        geometry = self.renderer.geometry
        if path not in geometry.model_slots:
            return False
        from trident.assets.scene_loader import (
            load_model, resolve_model_textures,
        )

        data = load_model(path)
        if not data.meshes:
            # a transiently broken file (mid-save, parse salvage yielding
            # zero meshes) must NOT wipe the live geometry
            raise ValueError(f"{path}: re-import produced no meshes")
        resolve_model_textures(data, self.renderer)
        geometry.replace_model(path, data.meshes, data.materials)
        if data.skeleton is not None or data.clips:
            from trident.anim.service import AnimationAssetService

            AnimationAssetService.get().register_runtime_asset(
                path, data.skeleton, data.clips)
        return True

    # -- frame loop -------------------------------------------------------------------
    def update(self) -> float:
        dt = self.time.tick()
        self.input.begin_frame()
        self.process_reload_events()
        for layer in self.layers:
            layer.update(self, dt)
        if self.scene.playing:
            self.scene.update(dt)
        self.input.end_frame()
        return dt

    def render(self):
        for layer in self.layers:
            layer.render(self)
        out = self.renderer.draw_frame()
        self._post_frame(out)
        return out

    def _post_frame(self, out, frame=None) -> None:
        """Readback-consuming subsystems: AI interpolation, dataset capture,
        video recording — throttled like the reference (66 ms AI cadence).
        `frame` short-circuits the readback when the caller already holds
        the presented uint8 image (the live viewer's loop)."""
        need_readback = (self.frame_generator.stats.enabled
                         or self.dataset_recorder.running
                         or self.video_encoder.active)
        if not need_readback:
            return
        if frame is None:
            frame = self.renderer.read_frame(out)
        if self.video_encoder.active:
            self.video_encoder.submit_frame(frame)
        rgb = frame[..., :3].astype(np.float32) / 255.0
        rec_index = None
        if self.dataset_recorder.running:
            rec_index = self.dataset_recorder.record_input_frame(rgb)
        if self.frame_generator.stats.enabled:
            now = _time.monotonic()
            if (now - self._ai_last_submit) * 1000.0 >= self.config.ai.cadence_ms:
                self._ai_last_submit = now
                job = self.frame_generator.process_frame(rgb)
                # pairing map: the AI output for THIS source frame must be
                # written under the recorder index of the SAME frame —
                # the generator's own job counter runs on a different
                # cadence than the 0.5s dataset throttle, so using it
                # directly silently mispaired the whole dataset
                if job is not None and rec_index is not None:
                    self._ai_job_to_dataset[job] = rec_index
            result = self.frame_generator.try_consume_output()
            if result is not None:
                index, ai_frame = result
                rec_idx = self._ai_job_to_dataset.pop(index, None)
                if rec_idx is not None:
                    self.dataset_recorder.record_ai_output(rec_idx, ai_frame)
                h, w = self.renderer.viewports[self.renderer.active_viewport].height, \
                    self.renderer.viewports[self.renderer.active_viewport].width
                self.renderer.set_ai_frame(_upscale(ai_frame, h, w),
                                           self.config.ai.blend)

    def run(self, frames: Optional[int] = None,
            on_frame: Optional[Callable[[int, object], None]] = None) -> None:
        """Run the loop for `frames` iterations (None = until stopped)."""
        self.running = True
        count = 0
        while self.running and (frames is None or count < frames):
            self.update()
            out = self.render()
            if on_frame is not None:
                on_frame(count, out)
            count += 1

    def shutdown(self) -> None:
        self.running = False
        for layer in reversed(self.layers):
            layer.shutdown(self)
        self.frame_generator.shutdown()
        self.dataset_recorder.stop()
        if self.video_encoder.active:
            self.video_encoder.end_session()


def _upscale(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-neighbor upscale of the AI net output to the framebuffer
    (the reference samples the AI texture by screen UV — same effect)."""
    yi = (np.arange(h) * img.shape[0] / h).astype(np.int64)
    xi = (np.arange(w) * img.shape[1] / w).astype(np.int64)
    return img[yi][:, xi]
