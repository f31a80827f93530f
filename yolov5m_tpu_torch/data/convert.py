"""Pillow 12.1.0's ``convert("RGB")`` of a decoded image's samples, shared by
the port's PNM and TIFF readers (data/pnm.py, data/tiff.py).

``to_rgb(mode, samples, palette)``: samples are (h, w, bands) or (h, w)
as Pillow holds the mode (4-byte pixels for LA, PA, RGB, RGBA, CMYK: the
grey, palette index or colour in the first bytes, alpha or K in the
fourth). Grey modes repeat their value, clipped to 0..255 (``I``,
``I;16``, ``I;16B``), ``F`` clipped and truncated toward zero (NaN 0),
CMYK as Pillow's ``cmyk2rgb``, alpha dropped, ``P`` and ``PA`` through
the palette: ``RGB;L`` bytes (all reds, then greens, then blues) of
``len // 3`` entries, black past them and black without one, ``LAB`` (L,
a + 128, b + 128 in the first three bytes) through LittleCMS's transform
from its Lab profile to sRGB as lcms evaluates it on 8-bit pixels (the
port's C, csrc/lab_convert.cc, through ``native.lab_to_srgb``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def palette_table(palette: Optional[bytes]) -> np.ndarray:
    """(256, 3) uint8 colours of an RGB;L palette, black past its end."""
    table = np.zeros((256, 3), np.uint8)
    if palette:
        n = min(len(palette) // 3, 256)
        pal = np.frombuffer(palette, np.uint8)
        for c in range(3):
            table[:n, c] = pal[c * n:(c + 1) * n]
    return table


def to_rgb(mode: str, samples: np.ndarray,
           palette: Optional[bytes] = None) -> np.ndarray:
    """(h, w, 3) uint8: Pillow's ``convert("RGB")`` of samples of mode."""
    if samples.ndim == 2:
        samples = samples[..., None]
    if mode in ("RGB", "RGBA"):
        return np.ascontiguousarray(samples[..., :3])
    if mode == "CMYK":
        s = samples.astype(np.int32)
        nk = 255 - s[..., 3:]
        return np.clip(nk - _muldiv255(s[..., :3], nk), 0, 255).astype(
            np.uint8)
    if mode in ("P", "PA"):
        return palette_table(palette)[samples[..., 0]]
    if mode == "LAB":
        from yolov5m_tpu_torch.data import native
        return native.lab_to_srgb(samples)
    if mode == "F":
        f = samples[..., 0]
        grey = np.where(f > 0, np.minimum(f, 255), 0).astype(np.uint8)
    elif mode in ("I", "I;16", "I;16B"):
        grey = np.clip(samples[..., 0], 0, 255).astype(np.uint8)
    else:                                  # "1" (0 or 255), "L", "LA"
        grey = samples[..., 0]
    return np.repeat(grey[..., None], 3, axis=2)
