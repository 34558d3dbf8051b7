"""Hot-reloadable user shading modules (the GLSL-pipeline-reload analogue).

Reference: Pipeline.cpp:997-1058 watches fragment-shader source on disk and
rebuilds the Vulkan pipeline when it changes, keeping the OLD pipeline when
the new source fails to compile. The analogue here: the "shader" is a
Python module defining a jit-traceable `shade(...)` function that replaces
the built-in Cook-Torrance lighting (ops/shading.shade_pbr); a reload swaps
in a NEW function object, which is a distinct jit static → XLA retraces and
recompiles the frame function exactly like a pipeline rebuild (and the
retrace counter in utils/profiling.py is the rebuild telemetry). A module
that fails to import or lacks `shade` keeps the previous function live —
the reference's failed-compile semantics.

Shader module contract (all arrays are JAX tracers under jit):

    def shade(world, normal, albedo, metallic, roughness,
              ambient_strength, camera_pos, lights, dir_shadow=None):
        '''world/normal/albedo (H,W,3); metallic/roughness/
        ambient_strength (H,W,1); camera_pos (3,); lights is
        render/types.LightParams; dir_shadow (H,W,1) directional-light
        shadow factor or None. Return (H,W,3) linear HDR rgb.'''

The engine applies tonemap/background/AI-blend around it unchanged, so a
custom shader composes with shadows, bloom, supersampling, banding and the
neural upscaler.

Memory note: each reload's new function object is a new static key in the
frame-function jit caches, so an edit session keeps one compiled frame
variant per save for the process lifetime (the reference destroys the old
VkPipeline; XLA's jit cache has no per-entry eviction). Bounded by the
number of edits — dozens of saves cost dozens of executables, acceptable
for a dev loop; call jax.clear_caches() if a marathon session needs it.
"""

from __future__ import annotations

import importlib.util
import logging
import os
from typing import Callable, Optional

logger = logging.getLogger(__name__)


class ShaderHook:
    """Holds the active custom shading function and its file identity.

    `fn` is None when no custom shader is set (the engine uses the built-in
    PBR). `version` increments on every successful (re)load — renderer
    caches key on it so an edited shader invalidates idle-frame caches.
    """

    def __init__(self) -> None:
        self.path: Optional[str] = None
        self.fn: Optional[Callable] = None
        self.version: int = 0
        self.last_error: Optional[str] = None

    def load(self, path: str) -> bool:
        """(Re)load `path` as the active shader module. Returns True on
        success. On ANY failure (import error, missing/non-callable
        `shade`) the previous function stays live and `last_error` holds
        the diagnostic — a broken edit must not take down the frame."""
        try:
            name = f"_trident_custom_shader_v{self.version + 1}"
            spec = importlib.util.spec_from_file_location(name, path)
            if spec is None or spec.loader is None:
                raise ImportError(f"cannot load module from {path}")
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            fn = getattr(module, "shade", None)
            if not callable(fn):
                raise AttributeError(
                    f"{path} does not define a callable `shade`")
        except Exception as exc:  # keep the old pipeline live
            self.last_error = f"{type(exc).__name__}: {exc}"
            logger.warning("custom shader %s failed to load (%s); keeping "
                           "previous shader", path, self.last_error)
            return False
        self.path = os.path.abspath(path)
        self.fn = fn
        self.version += 1
        self.last_error = None
        logger.info("custom shader loaded: %s (v%d)", path, self.version)
        return True

    def clear(self) -> None:
        self.path = None
        self.fn = None
        self.version += 1
        self.last_error = None

    def matches(self, path: str) -> bool:
        """Is `path` the file backing the active shader? (Watcher events
        carry their own path spelling.)"""
        if self.path is None:
            return False
        try:
            return os.path.samefile(path, self.path)
        except OSError:
            return os.path.abspath(path) == self.path
