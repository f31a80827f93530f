"""The glyph table of the port's text renderer
(yolov5m_tpu_torch/utils/fonts/dejavusans_hinted.bin).

matplotlib draws text with FreeType: DejaVu Sans, ``text.hinting``
``force_autohint`` and ``text.hinting_factor`` 8 (the font set 8 times
wider, then a transform of 1/8 in x). The port draws the same glyphs from
this table: for each (size in points, dpi) pair that the prediction images
use, and for each printable ASCII character (0x20-0x7E),

- the hinted outline, as ``FT2Font.load_char(c, FORCE_AUTOHINT)`` then
  ``get_path()`` give it: MOVETO / LINETO / CURVE3 / CLOSEPOLY codes and
  their points in 26.6 fixed point (1/64 px, exact);
- the pen advance of the glyph (``FT_MulFix(horiAdvance, 1/8)``: the
  slot's advance through that transform);
- the kerning of every pair, as ``FT2Font.get_kerning`` gives it (already
  divided by the hinting factor), where it is not 0.

An on-point between two CURVE3 controls that FreeType made as their
midpoint is stored as floor((c1 + c2) / 2): the rasterizer computes it
from the translated outline, whose coordinates are never negative, while
``get_path`` truncated it toward 0 at the origin.

The file is a JSON header line (names, dtypes, shapes and offsets of the
arrays) followed by the arrays' bytes, little-endian; it is made the same
to the byte on every run. Remake it (matplotlib needed) with

  python -m tests.torch_glyph_table [path]
"""

import json
import os
import shutil
import sys

import numpy as np

FONT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "yolov5m_tpu_torch", "utils", "fonts")
TABLE = os.path.join(FONT_DIR, "dejavusans_hinted.bin")
LICENSE = os.path.join(FONT_DIR, "LICENSE_DEJAVU")

# (points, dpi): tick labels (medium = 10 pt) and box labels (xx-small =
# 0.579 * 10 pt) of plot_image at 200 dpi and of save_prediction_images at
# 150 dpi, and the latter's titles (large = 12 pt)
SIZES = ((10.0, 200.0), (10.0, 150.0), (0.579 * 10.0, 200.0),
         (0.579 * 10.0, 150.0), (1.2 * 10.0, 150.0))
FIRST, LAST = 0x20, 0x7E
MOVETO, LINETO, CURVE3, CLOSEPOLY = 1, 2, 3, 79


def size_key(points: float, dpi: float) -> str:
    """The table's name of a size: FreeType's 26.6 char size and the dpi
    (set_size truncates points * 64)."""
    return f"{int(points * 64)}_{int(dpi)}"


def _font():
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib.font_manager import FontProperties, findfont, get_font
    return get_font(findfont(FontProperties()))


def _floor_midpoints(codes: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """pts with every implied on-point between two conic controls moved
    from trunc to floor of the controls' mean."""
    pts = pts.copy()
    i = 0
    n = len(codes)
    while i + 3 < n:
        # CURVE3 takes two entries: (control, end)
        if codes[i] == CURVE3 and codes[i + 2] == CURVE3:
            # the on-point that ends one conic and starts the next
            c1, end, c2 = pts[i], pts[i + 1], pts[i + 2]
            s = c1 + c2
            trunc = np.trunc(s / 2).astype(np.int64)
            floor = s // 2
            implied = (end == trunc).all()
            if implied:
                pts[i + 1] = floor
        i += 2 if codes[i] == CURVE3 else 1
    return pts


def build_table() -> bytes:
    """The table's bytes."""
    from matplotlib.backends.backend_agg import get_hinting_flag
    from matplotlib import ft2font
    font = _font()
    flags = get_hinting_flag()
    chars = list(range(FIRST, LAST + 1))
    arrays = {}
    for points, dpi in SIZES:
        key = size_key(points, dpi)
        font.set_size(points, dpi)
        starts, adv, codes, xy = [0], [], [], []
        for c in chars:
            glyph = font.load_char(c, flags=flags)
            verts, cds = font.get_path()
            pts = np.round(np.asarray(verts, np.float64) * 64)
            assert (pts == np.asarray(verts) * 64).all(), (key, chr(c))
            pts = _floor_midpoints(np.asarray(cds), pts.astype(np.int64))
            codes.extend(int(k) for k in cds)
            xy.extend(pts.reshape(-1).tolist())
            starts.append(len(codes))
            # FT_MulFix(horiAdvance, 0x10000 / 8), rounded half away from 0
            adv.append((glyph.horiAdvance * 8192 + 0x8000) >> 16)
        index = {c: font.get_char_index(c) for c in chars}
        kern = []
        for a in chars:
            for b in chars:
                k = font.get_kerning(index[a], index[b],
                                     ft2font.Kerning.DEFAULT)
                if k:
                    kern.append((a, b, k))
        arrays[f"{key}/starts"] = np.asarray(starts, "<i4")
        arrays[f"{key}/advance"] = np.asarray(adv, "<i4")
        arrays[f"{key}/codes"] = np.asarray(codes, "u1")
        arrays[f"{key}/xy"] = np.asarray(xy, "<i2")
        arrays[f"{key}/kern"] = np.asarray(kern, "<i2").reshape(-1, 3)
    header, offset, blobs = [], 0, []
    for name, a in arrays.items():
        blob = np.ascontiguousarray(a).tobytes()
        header.append([name, a.dtype.str, list(a.shape), offset])
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps({"font": "DejaVuSans.ttf", "first": FIRST,
                       "sizes": [[p, d] for p, d in SIZES],
                       "arrays": header}, separators=(",", ":"))
    return head.encode() + b"\n" + b"".join(blobs)


def license_source() -> str:
    import matplotlib
    return os.path.join(os.path.dirname(matplotlib.__file__), "mpl-data",
                        "fonts", "ttf", "LICENSE_DEJAVU")


def main(path: str = TABLE) -> None:
    data = build_table()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    shutil.copyfile(license_source(),
                    os.path.join(os.path.dirname(path), "LICENSE_DEJAVU"))
    print(f"{path}: {len(data)} bytes")


if __name__ == "__main__":
    main(*sys.argv[1:])
