"""trident — a real-time 3D rendering framework in JAX.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of the C++/Vulkan
engine "Trident" (ThatTanishqTak/3D-Renderer): entity/component scenes with
text save/load and play-mode sandboxing, cameras and lights, a full raster
pipeline (skinned vertex stage, tile-binned Pallas rasterization with
early-Z, mipmapped texturing, Cook-Torrance PBR, skybox, sprites, text
overlay), an asset pipeline, skeletal animation, frame telemetry, dataset
recording, video export, and a neural frame-interpolation net trained and
served on the same chip.

Design stance (vs. the reference engine, see SURVEY.md):
  * scene state is pytrees + packed draw arrays, not descriptor sets
  * the frame is ONE jit function, not command buffers / barriers
  * rasterization is deferred: a Pallas (Triton) visibility kernel resolves a
    winner-triangle id + depth per pixel, then a single fused shading pass
    interpolates attributes and evaluates PBR once per pixel
"""

__version__ = "0.1.0"

from trident.core.config import EngineConfig  # noqa: F401

# TRIDENT_THREAD_CHECKS=1: install the cross-thread mutation detector
# (core/threadcheck.py — the validation-layer analogue). No-op otherwise.
from trident.core.threadcheck import maybe_install as _maybe_threadcheck

_maybe_threadcheck()
