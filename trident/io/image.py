"""Image IO (PIL-backed) — the stb_image / texture upload analogue.

Reference: Loader/TextureLoader.cpp forces RGBA8 (stbi 4 channels); here PIL
decodes PNG/JPG/BMP/TGA and we return (H,W,4) uint8. EXR/KTX cubemap loading
lives in assets/skybox.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def load_rgba8(path: str) -> np.ndarray:
    """Decode any supported texture file to (H,W,4) uint8. PIL handles the
    raster formats; .ktx2 containers and .svg vector art (rasterized at
    their native/declared size, TextureLoader.cpp:10-12 nanosvg analogue)
    get dedicated decoders."""
    lower = path.lower()
    if lower.endswith(".ktx2"):
        from trident.assets.ktx2 import load_ktx2_rgba8

        return load_ktx2_rgba8(path)
    if lower.endswith(".svg"):
        from trident.io.svg import rasterize_svg_file

        return rasterize_svg_file(path)
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGBA"), dtype=np.uint8)


def decode_rgba(blob: bytes):
    """bytes of any PIL-readable image → (H,W,4) uint8, or None on a
    corrupt payload. The ONE decode used for embedded images (glTF data
    URIs / GLB views, FBX Video Content) so dtype pinning and error
    handling can't drift between loaders."""
    import io as _io

    try:
        from PIL import Image

        with Image.open(_io.BytesIO(blob)) as im:
            return np.asarray(im.convert("RGBA"), dtype=np.uint8)
    except Exception as exc:
        from trident.core.log import get_logger

        get_logger("io.image").warning("embedded image decode failed: %s",
                                       exc)
        return None


def load_rgba8_mips(path: str):
    """(rgba, mips-or-None): like load_rgba8, but containers that carry
    their own mip chain (.ktx2 with levelCount > 1) also return the
    level 1.. images so texture slots can ingest the author's filtered
    mips (TextureLoader.cpp:417 libktx behavior) instead of re-deriving
    them with a box filter."""
    if path.lower().endswith(".ktx2"):
        from trident.assets.ktx2 import load_ktx2_rgba8_mips

        return load_ktx2_rgba8_mips(path)
    return load_rgba8(path), None


def save_png(path: str, rgba: np.ndarray) -> None:
    from PIL import Image

    rgba = np.asarray(rgba)
    if rgba.dtype != np.uint8:
        rgba = np.clip(np.round(rgba * 255.0), 0, 255).astype(np.uint8)
    mode = {1: "L", 3: "RGB", 4: "RGBA"}[rgba.shape[-1] if rgba.ndim == 3 else 1]
    Image.fromarray(rgba.squeeze() if mode == "L" else rgba, mode).save(path)


def checkerboard(size: int = 64, cells: int = 8,
                 color_a=(255, 255, 255, 255), color_b=(40, 40, 40, 255)) -> np.ndarray:
    """Procedural test texture."""
    y, x = np.mgrid[0:size, 0:size]
    cell = size // cells
    mask = ((x // cell) + (y // cell)) % 2 == 0
    out = np.where(mask[..., None], np.array(color_a, np.uint8), np.array(color_b, np.uint8))
    return out.astype(np.uint8)
