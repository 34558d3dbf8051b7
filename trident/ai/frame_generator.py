"""FrameGenerator: async frame-interpolation inference.

Reference: AI/FrameGenerator.{h,cpp} — a background worker with a bounded
job queue, input/output buffer reuse, cached tensor bindings, per-run
latency + running-average telemetry; ProcessFrame enqueues (non-blocking)
and TryConsumeOutput polls.

Here inference is a jitted JAX forward on the SAME chip as the renderer —
the reference's GPU-readback→ONNX→upload round-trip collapses to an async
device computation. The worker thread exists to keep host-side orchestration
(pairing frames, normalization) off the render thread, matching the
reference's threading model; the heavy math never leaves the device.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import numpy as np

from trident.core.log import get_logger

logger = get_logger("ai.framegen")


@dataclass
class AiDebugStats:
    """Telemetry surfaced to the AIDebugPanel analogue (Renderer.h:99-110)."""

    queue_depth: int = 0
    completed_count: int = 0
    last_inference_ms: float = 0.0
    average_inference_ms: float = 0.0
    enabled: bool = False


class FrameGenerator:
    def __init__(self, model=None, variables=None,
                 resolution: Tuple[int, int] = (256, 256),
                 base_channels: int = 32,
                 queue_limit: int = 2) -> None:
        self.resolution = resolution
        self.base_channels = base_channels
        self._model = model
        self._variables = variables
        self._apply = None
        self._jobs: "queue.Queue[Optional[Tuple[int, np.ndarray, np.ndarray]]]" = \
            queue.Queue(maxsize=queue_limit)
        self._done: "queue.Queue[Tuple[int, np.ndarray, float]]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._running = False
        self._prev_frame: Optional[np.ndarray] = None
        self._next_index = 0
        self._total_ms = 0.0
        self.stats = AiDebugStats()

    # -- lifecycle -----------------------------------------------------------------
    def initialise(self, checkpoint_dir: Optional[str] = None,
                   model=None, variables=None) -> bool:
        """Load weights (checkpoint dir) or adopt an in-memory model; jit once."""
        import jax
        import jax.numpy as jnp

        if model is not None:
            self._model, self._variables = model, variables
        elif checkpoint_dir is not None:
            from trident.ai.train import TrainConfig, load_checkpoint

            try:
                self._model, self._variables = load_checkpoint(
                    checkpoint_dir,
                    TrainConfig(resolution=self.resolution,
                                base_channels=self.base_channels))
            except Exception as exc:
                logger.warning("AI model load failed (%s): %s — AI disabled",
                               checkpoint_dir, exc)
                return False
        if self._model is None:
            return False

        model, variables = self._model, self._variables

        @jax.jit
        def forward(inputs):
            return model.apply(variables, inputs, train=False)

        self._apply = forward
        # a previous shutdown() can leave its None sentinel (and stale
        # jobs) in the queue when the old worker exited via the _running
        # check instead of consuming it — a fresh worker would dequeue
        # the stale sentinel first and die silently
        while True:
            try:
                self._jobs.get_nowait()
            except queue.Empty:
                break
        self._running = True
        self._worker = threading.Thread(target=self._loop, name="ai-inference",
                                        daemon=True)
        self._worker.start()
        self.stats.enabled = True
        logger.info("frame generator initialised at %sx%s", *self.resolution)
        return True

    def shutdown(self) -> None:
        if not self._running:
            return
        self._running = False
        try:
            self._jobs.put_nowait(None)
        except queue.Full:
            pass
        if self._worker is not None:
            self._worker.join(timeout=5.0)
        self.stats.enabled = False

    # -- API (reference: ProcessFrame / TryConsumeOutput) ----------------------------
    def process_frame(self, frame: np.ndarray) -> Optional[int]:
        """Submit the latest rendered frame (H,W,3 float [0,1]). Pairs it
        with the previous submission; non-blocking (drops when busy).
        Returns the job index if enqueued."""
        if not self._running:
            return None
        frame = np.asarray(frame, np.float32)
        prev, self._prev_frame = self._prev_frame, frame
        if prev is None or prev.shape != frame.shape:
            return None
        index = self._next_index
        try:
            self._jobs.put_nowait((index, prev, frame))
        except queue.Full:
            return None
        self._next_index += 1
        self.stats.queue_depth = self._jobs.qsize()
        return index

    def try_consume_output(self) -> Optional[Tuple[int, np.ndarray]]:
        """Poll for a finished interpolation (index, (H,W,3) float)."""
        try:
            index, frame, ms = self._done.get_nowait()
        except queue.Empty:
            return None
        self.stats.completed_count += 1
        self.stats.last_inference_ms = ms
        self._total_ms += ms
        self.stats.average_inference_ms = self._total_ms / self.stats.completed_count
        self.stats.queue_depth = self._jobs.qsize()
        return index, frame

    # -- worker ---------------------------------------------------------------------
    def _resize(self, frame: np.ndarray) -> np.ndarray:
        h, w = self.resolution
        if frame.shape[:2] == (h, w):
            return frame
        # BILINEAR, matching the training data pipeline (ai/dataset.py
        # resizes with PIL BILINEAR): nearest-neighbor decimation at
        # inference feeds the net an aliased input distribution its
        # PSNR-selected weights never saw
        sh, sw = frame.shape[0], frame.shape[1]
        yf = (np.arange(h) + 0.5) * sh / h - 0.5
        xf = (np.arange(w) + 0.5) * sw / w - 0.5
        y0 = np.clip(np.floor(yf).astype(np.int64), 0, sh - 1)
        x0 = np.clip(np.floor(xf).astype(np.int64), 0, sw - 1)
        y1 = np.minimum(y0 + 1, sh - 1)
        x1 = np.minimum(x0 + 1, sw - 1)
        wy = np.clip(yf - y0, 0.0, 1.0).astype(np.float32)[:, None, None]
        wx = np.clip(xf - x0, 0.0, 1.0).astype(np.float32)[None, :, None]
        top = frame[y0][:, x0] * (1 - wx) + frame[y0][:, x1] * wx
        bot = frame[y1][:, x0] * (1 - wx) + frame[y1][:, x1] * wx
        return top * (1 - wy) + bot * wy

    def _loop(self) -> None:
        import jax
        import jax.numpy as jnp

        while self._running:
            job = self._jobs.get()
            if job is None:
                break
            index, prev, cur = job
            t0 = time.perf_counter()
            try:
                inp = np.concatenate([self._resize(prev), self._resize(cur)],
                                     axis=-1)[None]
                out = np.asarray(jax.block_until_ready(
                    self._apply(jnp.asarray(inp))))[0]
                ms = (time.perf_counter() - t0) * 1000.0
                self._done.put((index, out, ms))
            except Exception as exc:
                logger.warning("inference failed: %s", exc)
