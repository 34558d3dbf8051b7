"""Text overlay: queued strings → alpha-composited overlay.

Reference: Renderer/TextRenderer.{h,cpp} — stb_truetype atlas, per-viewport
queued text, dedicated alpha-blend pipeline after the scene pass. Here text
is rasterized host-side (PIL, with a bitmap fallback) into a per-viewport
RGBA overlay that the renderer alpha-composites onto the frame on device —
UI text is an overlay concern, not 3D geometry.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from trident.core.log import get_logger

logger = get_logger("io.text")


@dataclass
class QueuedText:
    text: str
    x: int
    y: int
    color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    size: int = 16


class TextOverlay:
    """Per-viewport text queues → (H,W,4) uint8 overlay images."""

    def __init__(self, font_path: Optional[str] = None) -> None:
        self._queues: Dict[int, List[QueuedText]] = {}
        self._font_path = font_path
        self._fonts: Dict[int, object] = {}

    def queue_text(self, viewport_id: int, text: str, x: int, y: int,
                   color=(1.0, 1.0, 1.0, 1.0), size: int = 16) -> None:
        self._queues.setdefault(viewport_id, []).append(
            QueuedText(text, int(x), int(y), tuple(color), int(size)))

    def begin_frame(self) -> None:
        self._queues.clear()

    def clear_viewport(self, viewport_id: int) -> None:
        self._queues.pop(viewport_id, None)

    def has_text(self, viewport_id: int) -> bool:
        return bool(self._queues.get(viewport_id))

    def _font(self, size: int):
        if size not in self._fonts:
            from PIL import ImageFont

            font = None
            if self._font_path:
                try:
                    font = ImageFont.truetype(self._font_path, size)
                except OSError:
                    pass
            if font is None:
                try:
                    font = ImageFont.truetype(
                        "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf", size)
                except OSError:
                    try:
                        # PIL >= 9.2: the default bitmap font scales; a
                        # sizeless fallback would render EVERY queued size
                        # at ~11px while the per-size cache hides it
                        font = ImageFont.load_default(size=size)
                    except TypeError:
                        font = ImageFont.load_default()
            self._fonts[size] = font
        return self._fonts[size]

    def render_overlay(self, viewport_id: int, width: int, height: int) -> Optional[np.ndarray]:
        """Rasterize this viewport's queue → (H,W,4) uint8 (None if empty)."""
        queue = self._queues.get(viewport_id)
        if not queue:
            return None
        from PIL import Image, ImageDraw

        img = Image.new("RGBA", (width, height), (0, 0, 0, 0))
        draw = ImageDraw.Draw(img)
        for item in queue:
            rgba = tuple(int(np.clip(c, 0, 1) * 255) for c in item.color)
            draw.text((item.x, item.y), item.text, fill=rgba,
                      font=self._font(item.size))
        return np.asarray(img, dtype=np.uint8)


def composite_overlay(frame: np.ndarray, overlay: np.ndarray) -> np.ndarray:
    """Host-side alpha-over compositing (uint8)."""
    a = overlay[..., 3:4].astype(np.float32) / 255.0
    rgb = (overlay[..., :3].astype(np.float32) * a
           + frame[..., :3].astype(np.float32) * (1.0 - a))
    out = frame.copy()
    out[..., :3] = np.clip(np.round(rgb), 0, 255).astype(np.uint8)
    return out
