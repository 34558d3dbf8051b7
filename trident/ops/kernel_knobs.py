"""Programmatic registry of the upscaler's knobs (SURVEY §5 config
unification).

The knobs are module globals of ai/upscaler.py, read as plain Python
statics at trace time and defaulted from TRIDENT_* env vars at import.
This registry makes them settable per run:

  * ``apply({"d2s_mode": "pad"})`` — set knobs at runtime and revalidate
  * ``snapshot()`` — the current values as a plain dict
  * ``trace_key()`` — a hashable fingerprint of every knob; the renderer
    passes it as a static jit argument so TWO DIFFERENT CONFIGS RENDER
    CORRECTLY IN ONE PROCESS (each gets its own trace instead of silently
    sharing one)
  * ``overrides(...)`` — context manager for scoped sweeps

Env vars remain the import-time DEFAULTS; RenderConfig.kernel and sweep
scripts drive apply().
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Any, Dict, Optional, Tuple

# knob name → (module path, attribute).
_KNOBS: Dict[str, Tuple[str, str]] = {
    "upscale_v2": ("trident.ai.upscaler", "V2"),
    "d2s_mode": ("trident.ai.upscaler", "D2S_MODE"),
    "upscale_dtype": ("trident.ai.upscaler", "UPSCALE_DTYPE"),
}


def _mod(path: str):
    return importlib.import_module(path)


def snapshot() -> Dict[str, Any]:
    """Current value of every registered knob."""
    return {name: getattr(_mod(m), a) for name, (m, a) in _KNOBS.items()}


def apply(overrides: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Set knobs by name, revalidate + recompute deriveds; returns the
    previous values of the knobs that changed (feed back to apply() to
    restore). Unknown names raise — a typo'd sweep knob must fail loudly,
    not silently bench the defaults."""
    if not overrides:
        return {}
    unknown = set(overrides) - set(_KNOBS)
    if unknown:
        raise KeyError(f"unknown kernel knobs: {sorted(unknown)}; "
                       f"known: {sorted(_KNOBS)}")
    prev: Dict[str, Any] = {}
    for name, value in overrides.items():
        m, a = _KNOBS[name]
        mod = _mod(m)
        prev[name] = getattr(mod, a)
        setattr(mod, a, value)
    try:
        _revalidate()
    except Exception:
        for name, value in prev.items():   # all-or-nothing
            m, a = _KNOBS[name]
            setattr(_mod(m), a, value)
        _revalidate()
        raise
    return prev


def _revalidate() -> None:
    up = _mod("trident.ai.upscaler")
    if up.D2S_MODE not in ("convt", "pad", "xla"):
        raise ValueError(f"d2s_mode={up.D2S_MODE!r}: expected "
                         "convt | pad | xla")
    if up.UPSCALE_DTYPE not in ("bf16", "f32"):
        raise ValueError(f"upscale_dtype={up.UPSCALE_DTYPE!r}: "
                         "expected bf16 | f32")


def trace_key() -> tuple:
    """Hashable fingerprint of the active knob set — include in every jit
    cache key / static argument whose trace bakes kernel constants in."""
    return tuple(sorted((k, v) for k, v in snapshot().items()))


# captured at the bottom of this module's import (= the TRIDENT_* env
# values): the deterministic baseline every Renderer builds from, so a
# previous renderer's overlay can never leak into the next one
# constructed in the same process
_ENV_DEFAULTS: Dict[str, Any] = {}


def env_defaults() -> Dict[str, Any]:
    return dict(_ENV_DEFAULTS)


@contextlib.contextmanager
def overrides(**knobs):
    """Scoped knob overrides: with overrides(d2s_mode="pad"): ..."""
    prev = apply(knobs)
    try:
        yield
    finally:
        apply(prev)


_ENV_DEFAULTS.update(snapshot())
