"""Host-side image decode, size reading, resize and letterbox, in numpy.

Port of the host part of ``yolov5m_tpu/data/native.py``. Binary PPM is
decoded (and its size read from the header) with numpy, other formats
with PIL where it is installed; the JAX package's libjpeg path is not
ported. The JAX package runs the resize in a C library
(``native/preprocess.cc``); here it is numpy with the C path's float32
formula:

  fy = clamp((y + 0.5f) * (sh / dh) - 0.5f, 0, sh - 1),  y0 = (int) fy,
  ty = fy - y0,  lerp(a, b, t) = a + t * (b - a),  out = (uint8)(v + 0.5f)

The C library is built with -O3 -march=native, so its compiler may fuse
the lerp into an FMA: where a resize happens the two can differ by one
code per pixel; where none happens the letterbox is exact.
"""

from __future__ import annotations

import io
from typing import Optional, Tuple

import numpy as np

_F = np.float32


def _axis(src: int, dst: int):
    """Source indices (i0, i1) and f32 weights for one axis (C formula)."""
    scale = _F(src) / _F(dst)
    f = (np.arange(dst, dtype=_F) + _F(0.5)) * scale - _F(0.5)
    f = np.minimum(np.maximum(f, _F(0.0)), _F(src - 1))
    i0 = f.astype(np.int64)
    i1 = np.minimum(i0 + 1, src - 1)
    return i0, i1, f - i0.astype(_F)


def _lerp(a, b, t):
    return a + t * (b - a)


def resize_bilinear(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an (h, w, c) or (h, w) uint8 image to (w, h):
    half-pixel centers, no antialiasing, rounded half up."""
    w, h = int(size_wh[0]), int(size_wh[1])
    if img.shape[0] == h and img.shape[1] == w:
        return img
    sh, sw = img.shape[:2]
    y0, y1, ty = _axis(sh, h)
    x0, x1, tx = _axis(sw, w)
    f = np.asarray(img, np.uint8).astype(_F)
    gray = f.ndim == 2
    if gray:
        f = f[..., None]
    ty, tx = ty[:, None, None], tx[None, :, None]
    top = _lerp(f[y0][:, x0], f[y0][:, x1], tx)
    bot = _lerp(f[y1][:, x0], f[y1][:, x1], tx)
    out = (_lerp(top, bot, ty) + _F(0.5)).astype(np.uint8)
    return out[..., 0] if gray else out


def letterbox(img: np.ndarray, new_hw: Tuple[int, int], fill: int = 114,
              scaleup: bool = True):
    """Resize keeping the aspect ratio, then pad to new_hw with ``fill``.
    Returns (image uint8, (ratio, ratio), (dw, dh))."""
    sh, sw = img.shape[:2]
    nh, nw = new_hw
    r = min(nh / sh, nw / sw)
    if not scaleup:
        r = min(r, 1.0)
    uw, uh = int(round(sw * r)), int(round(sh * r))
    dw, dh = (nw - uw) / 2, (nh - uh) / 2
    resized = resize_bilinear(img, (uw, uh))
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    dst = np.full((nh, nw) + img.shape[2:], fill, dtype=np.uint8)
    dst[top:top + uh, left:left + uw] = resized
    return dst, (r, r), (dw, dh)


def _ppm_token(data: bytes, pos: int):
    """Next whitespace-separated header token of a PNM file, skipping
    '#' comments. Returns (token, position after it)."""
    n = len(data)
    while pos < n:
        ch = data[pos:pos + 1]
        if ch == b"#":
            while pos < n and data[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
        elif ch.isspace():
            pos += 1
        else:
            break
    start = pos
    while pos < n and not data[pos:pos + 1].isspace():
        pos += 1
    return data[start:pos], pos


def _ppm_header(data: bytes):
    """(w, h, offset of the pixel data) of a binary PPM (P6, maxval 255)
    header at the start of ``data``, or None."""
    if data[:2] != b"P6":
        return None
    pos = 2
    fields = []
    for _ in range(3):
        tok, pos = _ppm_token(data, pos)
        if not tok.isdigit():
            return None
        fields.append(int(tok))
    w, h, maxval = fields
    if maxval != 255 or w <= 0 or h <= 0 or pos >= len(data):
        return None
    return w, h, pos + 1         # the single whitespace after maxval


def decode_ppm(data: bytes) -> Optional[np.ndarray]:
    """Binary PPM (P6, maxval 255) -> (h, w, 3) uint8, or None."""
    header = _ppm_header(data)
    if header is None:
        return None
    w, h, pos = header
    if len(data) - pos < w * h * 3:
        return None
    return np.frombuffer(data, np.uint8, w * h * 3, pos).reshape(h, w, 3)


def encode_ppm(img: np.ndarray) -> bytes:
    """(h, w, 3) uint8 -> binary PPM (P6) bytes."""
    h, w = img.shape[:2]
    return b"P6\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(
        img, np.uint8).tobytes()


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """(h, w, 3) RGB uint8 from image bytes, or None when undecodable.
    Binary PPM is decoded with numpy; anything else goes to PIL where PIL
    is installed."""
    img = decode_ppm(data)
    if img is not None:
        return img
    try:
        from PIL import Image
    except ImportError:
        return None
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))
    except Exception:  # PIL raises many types on corrupt input
        return None


def load_image_rgb(path: str) -> np.ndarray:
    """(h, w, 3) RGB uint8 from an image file: binary PPM with numpy,
    other formats with PIL where it is installed. A file that cannot be
    decoded raises ValueError naming it."""
    with open(path, "rb") as f:
        img = decode_image(f.read())
    if img is None:
        raise ValueError(f"{path}: cannot decode (binary PPM is read with "
                         "numpy; other formats need PIL)")
    return img


# a PPM header with a comment or two fits well inside this many bytes
_HEADER_BYTES = 4096


def read_image_size(path: str) -> Tuple[int, int]:
    """(h, w) of an image file without decoding its pixels: from the
    header for binary PPM, through PIL for other formats where it is
    installed. A file that cannot be read raises ValueError naming it."""
    with open(path, "rb") as f:
        header = _ppm_header(f.read(_HEADER_BYTES))
    if header is not None:
        return header[1], header[0]
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        try:
            with Image.open(path) as im:
                w, h = im.size
            return h, w
        except Exception:  # PIL raises many types on corrupt input
            pass
    raise ValueError(f"{path}: cannot read the image size (binary PPM is "
                     "read with numpy; other formats need PIL)")
