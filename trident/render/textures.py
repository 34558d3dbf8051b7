"""Texture slot cache: the 256-slot sampler-array analogue.

Reference: Renderer.cpp:3404-3745 — path-keyed cache of up to 256 combined
image samplers; slot 0 is a 1×1 white fallback; slots resolve lazily and
hot-reload replaces in place. Here slots live in ONE device-resident mip
pyramid (a tuple of (S,e,e,4) uint8 arrays) rebuilt on change — asset
uploads stay off the per-frame path, and a version counter tells the
renderer when to refresh its device arrays.

Non-square / non-pow2 images sit in the top-left of their padded tile; the
sampler wraps by the ACTUAL size so REPEAT addressing stays correct.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from trident.render.types import TextureArrays


def _box_downsample(img: np.ndarray) -> np.ndarray:
    """2× box filter; odd dims are truncated (sizes are pow2-padded anyway)."""
    h, w = img.shape[:2]
    h2, w2 = max(h // 2, 1), max(w // 2, 1)
    img = img[: h2 * 2, : w2 * 2].astype(np.float32)
    if h >= 2 and w >= 2:
        out = (img[0::2, 0::2] + img[1::2, 0::2] + img[0::2, 1::2] + img[1::2, 1::2]) * 0.25
    elif h >= 2:
        out = (img[0::2] + img[1::2]) * 0.5
    elif w >= 2:
        out = (img[:, 0::2] + img[:, 1::2]) * 0.5
    else:
        out = img
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


class TextureSlots:
    """Host-side slot registry + packed device arrays."""

    def __init__(self, max_slots: int = 256, edge: int = 256):
        # (a former mip_count parameter was never honored — device_arrays
        # derives each slot's pyramid depth from its own pow2 edge)
        self.max_slots = max_slots
        self.edge = edge
        self._images: List[np.ndarray] = []     # mip-0 uint8 RGBA, original size
        self._mips: List[Optional[List[np.ndarray]]] = []  # file mip chains
        self._sizes: List[Tuple[int, int]] = []
        self._by_path: Dict[str, int] = {}
        self.version = 0
        self._device: Optional[TextureArrays] = None
        self._device_version = -1
        # slot 0: white fallback
        self._push(np.full((1, 1, 4), 255, np.uint8), "__white__")

    def _push(self, rgba: np.ndarray, key: str,
              mips: Optional[List[np.ndarray]] = None) -> int:
        slot = len(self._images)
        if slot >= self.max_slots:
            return 0  # out of slots → white fallback, like the reference
        self._images.append(rgba)
        self._mips.append(mips)
        self._sizes.append((rgba.shape[1], rgba.shape[0]))
        self._by_path[key] = slot
        self.version += 1
        return slot

    @staticmethod
    def _sanitize(rgba: np.ndarray) -> np.ndarray:
        rgba = np.asarray(rgba)
        if rgba.dtype != np.uint8:
            rgba = np.clip(np.round(np.asarray(rgba, np.float32) * 255.0), 0, 255).astype(np.uint8)
        if rgba.ndim == 2:
            rgba = rgba[..., None]
        if rgba.shape[-1] == 3:
            rgba = np.concatenate([rgba, np.full((*rgba.shape[:2], 1), 255, np.uint8)], axis=-1)
        elif rgba.shape[-1] == 1:
            rgba = np.concatenate([np.repeat(rgba, 3, axis=-1),
                                   np.full((*rgba.shape[:2], 1), 255, np.uint8)], axis=-1)
        return rgba

    def acquire(self, key: str, rgba: Optional[np.ndarray] = None,
                mips: Optional[List[np.ndarray]] = None) -> int:
        """Get-or-create a slot. If `rgba` is None the key must exist.
        `mips` is an optional author-provided mip chain (levels below
        mip 0, any suffix): file levels are used in place of the box
        downsample wherever their size matches the pyramid (libktx file
        mip-chain ingestion, TextureLoader.cpp:417)."""
        if key in self._by_path:
            return self._by_path[key]
        if rgba is None:
            return 0
        rgba = self._sanitize(rgba)
        if rgba.shape[0] > self.edge or rgba.shape[1] > self.edge:
            rgba = self._downscale_to_fit(rgba)
        mips = [self._sanitize(m) for m in mips] if mips else None
        return self._push(rgba, key, mips)

    def replace(self, key: str, rgba: np.ndarray,
                mips: Optional[List[np.ndarray]] = None) -> int:
        """Hot-reload: swap pixels in an existing slot (Renderer.cpp:2118-2188)."""
        rgba = self._sanitize(rgba)
        if rgba.shape[0] > self.edge or rgba.shape[1] > self.edge:
            rgba = self._downscale_to_fit(rgba)
        if key not in self._by_path:
            return self.acquire(key, rgba, mips)
        slot = self._by_path[key]
        self._images[slot] = rgba
        self._mips[slot] = [self._sanitize(m) for m in mips] if mips else None
        self._sizes[slot] = (rgba.shape[1], rgba.shape[0])
        self.version += 1
        return slot

    def _downscale_to_fit(self, rgba: np.ndarray) -> np.ndarray:
        while rgba.shape[0] > self.edge or rgba.shape[1] > self.edge:
            rgba = _box_downsample(rgba)
        return rgba

    def slot_count(self) -> int:
        return len(self._images)

    def lookup(self, key: str) -> int:
        return self._by_path.get(key, 0)

    # -- device packing -------------------------------------------------------
    def device_arrays(self) -> TextureArrays:
        """Pack all slots into ONE flat buffer of per-slot mip pyramids
        (cached by version): texel(s,l,y,x) sits at entry (sizes[s,2]<<8)
        + level_base(E_s,l) + y*((E_s>>l)+1) + x, and quads[entry] carries
        the full 2×2 bilinear block [(x,y),(x+1,y),(x,y+1),(x+1,y+1)] —
        one 16-byte row per tap, so a
        bilinear tap is ONE gather (trilinear two, nearest one). Levels
        carry wrap-gutter column lw := col 0 AND row lh := row 0, so
        REPEAT addressing never needs a second fetch. Each slot pads only
        to its OWN pow2 edge (memory ∝ actual texels; the 4× duplication
        is deliberate speed). Slot count is bucketed to multiples of 8 to
        limit retraces; slot bases align to 256 entries (so base>>8 is
        f32-exact for the resolve kernel)."""
        if self._device is not None and self._device_version == self.version:
            return self._device
        n = len(self._images)
        bucket = max(8, 1 << (n - 1).bit_length()) if n > 8 else 8
        s = min(((n + bucket - 1) // bucket) * bucket, self.max_slots)
        s = max(s, n)

        sizes = np.ones((s, 4), np.int32)
        chunks: List[np.ndarray] = []
        cursor = 0
        max_edge = 1
        for i in range(s):
            img = self._images[i] if i < n else np.full((1, 1, 4), 255, np.uint8)
            w0, h0 = (self._sizes[i] if i < n else (1, 1))
            e0 = 1 << int(max(w0, h0, 1) - 1).bit_length()   # pow2 ceil
            e0 = min(max(e0, 1), self.edge)
            max_edge = max(max_edge, e0)
            n_levels = e0.bit_length()                       # log2(e0)+1
            sizes[i] = (w0, h0, cursor >> 8, e0)
            # level chain: file-provided mips slot in wherever their size
            # matches the halved-by-2 pyramid; anything absent is box-
            # downsampled from the previous level (shape matching also
            # absorbs the downscale-to-fit shift of oversized sources)
            file_mips = (self._mips[i] if i < n else None) or []
            chain = [img]
            while len(chain) < n_levels:
                prev = chain[-1]
                want = (max(prev.shape[0] // 2, 1), max(prev.shape[1] // 2, 1))
                m = next((fm for fm in file_mips if fm.shape[:2] == want),
                         None)
                chain.append(m if m is not None else _box_downsample(prev))
            total = 0
            parts = []
            for l in range(n_levels):
                cur = chain[l]
                e = max(e0 >> l, 1)
                # (e+1, e+1) tile: texels + wrap gutters in x AND y
                tile = np.zeros((e + 1, e + 1, 4), np.uint8)
                ch, cw = min(cur.shape[0], e), min(cur.shape[1], e)
                tile[:ch, :cw] = cur[:ch, :cw]
                lw = min(max(int(w0) >> l, 1), e)
                lh = min(max(int(h0) >> l, 1), e)
                tile[:, lw] = tile[:, 0]       # REPEAT gutter at actual w
                tile[lh, :] = tile[0, :]       # REPEAT gutter at actual h
                flat = tile.reshape(-1, 4).astype(np.uint32)
                packed = (flat[:, 0] | (flat[:, 1] << 8)
                          | (flat[:, 2] << 16) | (flat[:, 3] << 24))
                # quad lanes: entry i = [i, i+1, i+stride, i+stride+1]
                stride = e + 1
                grid = packed.reshape(stride, stride)
                q = np.zeros((stride, stride, 4), np.uint32)
                q[..., 0] = grid
                q[:, :-1, 1] = grid[:, 1:]
                q[:-1, :, 2] = grid[1:, :]
                q[:-1, :-1, 3] = grid[1:, 1:]
                parts.append(q.reshape(-1, 4))
                total += stride * stride
            pad = (-(cursor + total)) % 256                  # align next base
            if pad:
                parts.append(np.zeros((pad, 4), np.uint32))
            chunk = np.concatenate(parts, axis=0)
            chunks.append(chunk)
            cursor += chunk.shape[0]

        quads = np.concatenate(chunks, axis=0)

        self._device = TextureArrays(
            quads=jnp.asarray(quads),
            sizes=jnp.asarray(sizes),
            max_level=jnp.asarray(max_edge.bit_length() - 1, jnp.int32),
        )
        self._device_version = self.version
        return self._device
