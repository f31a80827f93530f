"""Prediction images: boxes drawn on one image, and GT-vs-prediction epoch
dumps under SAVED_IMAGES/{run}/EPOCH_{n}/image_{i}.png.

Port of ``yolov5m_tpu/utils/plotting.py``, which draws with matplotlib
(Agg). The port draws the same figures without matplotlib, Pillow or
FreeType, pixel for pixel: the layout of the figure (subplot parameters,
the equal aspect, the tick locator and formatter, the text alignment, the
tight bounding box) runs here in matplotlib's order of float operations,
and the pixel work in the port's C library (``csrc/plot.cc``: FreeType's
gray rasterizer over the hinted DejaVu Sans outlines of
``utils/fonts/dejavusans_hinted.bin``, Agg's scanline rasterizer and
stroker, imshow's resample, matplotlib's blend). The PNG it writes has the
chunks matplotlib's has (IHDR RGBA 8-bit, tEXt "Software", pHYs); its
IDAT is Python's zlib.

Text is printable ASCII, the characters of the glyph table; a label name
with another character is refused (``check_labels``) before any work.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import struct
import zlib
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from yolov5m_tpu_torch.config import COCO_LABELS

_FONT_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fonts", "dejavusans_hinted.bin")
_FIRST, _LAST = 0x20, 0x7E
_CLOSEPOLY = 79

# matplotlib 3.10's defaults that the two figures read
_SOFTWARE = b"Matplotlib version3.10.8, https://matplotlib.org/"
_SUBPLOT = dict(left=0.125, right=0.9, bottom=0.11, top=0.88, wspace=0.2,
                hspace=0.2)
_TICK_SIZE, _TICK_WIDTH, _TICK_PAD = 3.5, 0.8, 3.5   # points
_SPINE_WIDTH = 0.8
_TITLE_PAD = 6.0
_BOX_WIDTH = 1.5          # the boxes' Rectangle
_LABEL_EDGE = 1.0         # the label's bbox patch (patch.linewidth)
_PAD_INCHES = 0.1         # savefig.pad_inches
_TICK_POINTS = 10.0       # xtick/ytick.labelsize "medium"
_LABEL_POINTS = 0.579 * 10.0   # "xx-small"
_TITLE_POINTS = 1.2 * 10.0     # "large"
_BLACK = (0.0, 0.0, 0.0, 1.0)
_WHITE = (1.0, 1.0, 1.0, 1.0)

# the tab20b colormap (matplotlib/_cm.py)
_TAB20B = (
    (0.2235294117647059, 0.23137254901960785, 0.4745098039215686),
    (0.3215686274509804, 0.32941176470588235, 0.6392156862745098),
    (0.4196078431372549, 0.43137254901960786, 0.8117647058823529),
    (0.611764705882353, 0.6196078431372549, 0.8705882352941177),
    (0.38823529411764707, 0.4745098039215686, 0.2235294117647059),
    (0.5490196078431373, 0.6352941176470588, 0.3215686274509804),
    (0.7098039215686275, 0.8117647058823529, 0.4196078431372549),
    (0.807843137254902, 0.8588235294117647, 0.611764705882353),
    (0.5490196078431373, 0.42745098039215684, 0.19215686274509805),
    (0.7411764705882353, 0.6196078431372549, 0.2235294117647059),
    (0.9058823529411765, 0.7294117647058823, 0.3215686274509804),
    (0.9058823529411765, 0.796078431372549, 0.5803921568627451),
    (0.5176470588235295, 0.23529411764705882, 0.2235294117647059),
    (0.6784313725490196, 0.28627450980392155, 0.2901960784313726),
    (0.8392156862745098, 0.3803921568627451, 0.4196078431372549),
    (0.9058823529411765, 0.5882352941176471, 0.611764705882353),
    (0.4823529411764706, 0.2549019607843137, 0.45098039215686275),
    (0.6470588235294118, 0.3176470588235294, 0.5803921568627451),
    (0.807843137254902, 0.42745098039215684, 0.7411764705882353),
    (0.8705882352941177, 0.6196078431372549, 0.8392156862745098),
)


# -- text ---------------------------------------------------------------------

_table = None


def _font_table() -> dict:
    global _table
    if _table is None:
        with open(_FONT_TABLE, "rb") as f:
            raw = f.read()
        nl = raw.index(b"\n")
        head = json.loads(raw[:nl])
        body = raw[nl + 1:]
        arrays = {}
        for name, dtype, shape, offset in head["arrays"]:
            arrays[name] = np.frombuffer(body, dtype, int(np.prod(shape)),
                                         offset).reshape(shape)
        _table = arrays
    return _table


def _size_key(points: float, dpi: float) -> str:
    # FreeType's char size is points * 64 truncated
    return f"{int(points * 64)}_{int(dpi)}"


def check_labels(labels: Sequence[str]) -> None:
    """Raise SystemExit naming the first character of a label name that
    the prediction images cannot draw (outside printable ASCII, or a name
    that matplotlib would read as mathtext)."""
    for name in labels:
        for ch in str(name):
            if not _FIRST <= ord(ch) <= _LAST:
                raise SystemExit(
                    f"label {name!r} has the character {ch!r} (U+{ord(ch):04X}),"
                    f" which the prediction images cannot draw: they take "
                    f"printable ASCII; pass --nosaveimgs (train) or leave out "
                    f"--save_pred (detect), or rename the class")
        if _is_math(f"{name}: 0.00"):
            raise SystemExit(
                f"label {name!r} would be drawn as mathtext (two '$'), which "
                f"the prediction images do not draw")


def _is_math(s: str) -> bool:
    # Text._preprocess_math: an even number (>= 2) of unescaped dollars
    dollars = s.count("$") - s.count(r"\$")
    return dollars > 0 and dollars % 2 == 0


class _Line:
    """One string set by FT2Font::set_text at a size: its glyph outlines
    moved to their pens, and its bbox in 26.6."""

    def __init__(self, s: str, key: str):
        t = _font_table()
        starts, adv = t[f"{key}/starts"], t[f"{key}/advance"]
        codes, xy = t[f"{key}/codes"], t[f"{key}/xy"]
        kern = _kerning(key)
        pen, prev = 0, None
        parts_c, parts_xy, gstarts = [], [], [0]
        xmin = ymin = 32000
        xmax = ymax = -32000
        for ch in s:
            c = ord(ch)
            if not _FIRST <= c <= _LAST:
                raise ValueError(f"no glyph for {ch!r}")
            if prev is not None:
                pen += kern.get((prev, c), 0)
            i0, i1 = int(starts[c - _FIRST]), int(starts[c - _FIRST + 1])
            cd = codes[i0:i1]
            p = xy[2 * i0:2 * i1].reshape(-1, 2).astype(np.int32)
            p[:, 0] += pen
            on = cd != _CLOSEPOLY
            if on.any():
                gx, gy = p[on, 0], p[on, 1]
                xmin, xmax = min(xmin, int(gx.min())), max(xmax, int(gx.max()))
                ymin, ymax = min(ymin, int(gy.min())), max(ymax, int(gy.max()))
            else:   # an empty outline's cbox is (0, 0, 0, 0), moved or not
                xmin, xmax = min(xmin, 0), max(xmax, 0)
                ymin, ymax = min(ymin, 0), max(ymax, 0)
            parts_c.append(cd)
            parts_xy.append(p)
            gstarts.append(gstarts[-1] + len(cd))
            pen += int(adv[c - _FIRST])
            prev = c
        if xmin > xmax:
            xmin = ymin = xmax = ymax = 0
        self.bbox = (xmin, ymin, xmax, ymax)
        self.codes = (np.concatenate(parts_c) if parts_c
                      else np.zeros(0, np.uint8))
        self.xy = np.ascontiguousarray(
            np.concatenate(parts_xy) if parts_xy else np.zeros((0, 2)),
            np.int32)
        self.starts = np.asarray(gstarts, np.int32)
        self.n = len(s)
        self.advance = pen

    def metrics(self) -> Tuple[float, float, float]:
        """RendererAgg.get_text_width_height_descent: (w, h, d) in px; the
        width is the pen's advance."""
        xmin, ymin, xmax, ymax = self.bbox
        return self.advance / 64.0, (ymax - ymin) / 64.0, -ymin / 64.0

    def bitmap(self) -> np.ndarray:
        """FT2Font::draw_glyphs_to_bitmap: the (h, w) coverage."""
        xmin, ymin, xmax, ymax = self.bbox
        w = (xmax - xmin) // 64 + 2
        h = (ymax - ymin) // 64 + 2
        out = np.zeros((h, w), np.uint8)
        from yolov5m_tpu_torch.data import native
        lib = native.plot_lib()
        codes = np.ascontiguousarray(self.codes, np.uint8)
        lib.plot_glyphs(_ptr(codes), _ptr(self.xy), _ptr(self.starts),
                        self.n, xmin, ymax, _ptr(out), w, h)
        return out


_kern_cache: dict = {}


def _kerning(key: str) -> dict:
    if key not in _kern_cache:
        _kern_cache[key] = {(int(a), int(b)): int(k)
                            for a, b, k in _font_table()[f"{key}/kern"]}
    return _kern_cache[key]


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _dptr(values) -> ctypes.Array:
    values = [float(v) for v in values]
    return (ctypes.c_double * len(values))(*values)


class _Text:
    """A one-line Text: matplotlib's _get_layout at rotation 0."""

    def __init__(self, s: str, points: float, dpi: float, halign: str,
                 valign: str):
        key = _size_key(points, dpi)
        self.s = s
        self.line = _Line(s, key)
        _, lp_h, lp_d = _Line("lp", key).metrics()
        if s:
            w, h, d = self.line.metrics()
        else:
            w = h = d = 0
        h = max(h, lp_h)
        d = max(d, lp_d)
        self.w, self.h, self.d = w, h, d
        baseline = h - d
        thisy = -(h - d)
        descent = d
        xmin, xmax, ymax = 0.0, w, 0.0
        ymin = thisy - descent
        width = xmax - xmin
        height = ymax - ymin
        if halign == "center":
            offsetx = (xmin + xmax) / 2
        elif halign == "right":
            offsetx = xmax
        else:
            offsetx = xmin
        if valign == "top":
            offsety = ymax
        elif valign == "baseline":
            offsety = ymin + descent
        elif valign == "center_baseline":
            offsety = ymin + height - baseline / 2.0
        else:
            offsety = ymin
        self.bbox = (xmin - offsetx, ymin - offsety, width, height)
        self.line_xy = (0.0 - offsetx, thisy - offsety)

    def extent(self, posx: float, posy: float) -> Tuple[float, float, float,
                                                         float]:
        """The window extent (x0, y0, x1, y1) at the display position."""
        x0, y0, w, h = self.bbox
        x1, y1 = x0 + w, y0 + h
        return x0 + posx, y0 + posy, x1 + posx, y1 + posy

    def textbox(self) -> Tuple[float, float, float, float]:
        """text._get_textbox: (x, y, w, h) of the text's bbox patch."""
        xt1, yt1 = self.line_xy
        yt1 = yt1 - self.d
        xt2, yt2 = xt1 + self.w, yt1 + self.h
        x_box, y_box = min(xt1, xt2), min(yt1, yt2)
        return x_box, y_box, max(xt1, xt2) - x_box, max(yt1, yt2) - y_box


# -- transforms ---------------------------------------------------------------
#
# Separable affines (sx, tx, sy, ty), composed as numpy composes matplotlib's
# 3x3 matrices: (b * a).tx = b.sx * a.tx + b.tx.

def _compose(a, b):
    """a then b."""
    return (b[0] * a[0], b[0] * a[1] + b[1], b[2] * a[2], b[2] * a[3] + b[3])


def _apply(t, x, y):
    return t[0] * x + t[1], t[2] * y + t[3]


def _bbox_to(x0, y0, x1, y1):
    """BboxTransformTo of a bbox given by its points."""
    return (x1 - x0, x0, y1 - y0, y0)


def _bbox_from(x0, y0, x1, y1):
    """BboxTransformFrom."""
    sx, sy = 1.0 / (x1 - x0), 1.0 / (y1 - y0)
    return (sx, -x0 * sx, sy, -y0 * sy)


def _transformed(t, x0, y0, x1, y1):
    """TransformedBbox's points: the corners' images, oriented as the
    input."""
    ax, bx = t[0] * x0 + t[1], t[0] * x1 + t[1]
    ay, by = t[2] * y0 + t[3], t[2] * y1 + t[3]
    xs = (min(ax, bx), max(ax, bx))
    ys = (min(ay, by), max(ay, by))
    if x0 > x1:
        xs = xs[::-1]
    if y0 > y1:
        ys = ys[::-1]
    return xs[0], ys[0], xs[1], ys[1]


def _matrix(t):
    """(sx, shy, shx, sy, tx, ty) for the C library."""
    return (t[0], 0.0, 0.0, t[2], t[1], t[3])


def _matrix2(tx_row, ty_row):
    """A blended transform: x from one affine, y from another."""
    return (tx_row[0], 0.0, 0.0, ty_row[2], tx_row[1], ty_row[3])


# -- the tick locator and formatter -------------------------------------------

_STEPS = np.array([0.1, 0.2, 0.25, 0.5, 1.0, 2.0, 2.5, 5.0, 10.0, 20.0])


def _scale_range(vmin, vmax, n):
    dv = abs(vmax - vmin)
    meanv = (vmax + vmin) / 2
    if abs(meanv) / dv < 100:
        offset = 0
    else:
        offset = math.copysign(10 ** (math.log10(abs(meanv)) // 1), meanv)
    scale = 10 ** (math.log10(dv / n) // 1)
    return scale, offset


def _closeto(ms, edge, offset, step):
    if offset > 0:
        digits = np.log10(offset / step)
        tol = min(0.4999, max(1e-10, 10 ** (digits - 12)))
    else:
        tol = 1e-10
    return abs(ms - edge) < tol


def _tick_values(vmin, vmax, nbins):
    """MaxNLocator(nbins, steps=[1, 2, 2.5, 5, 10]).tick_values."""
    if vmax < vmin:
        vmin, vmax = vmax, vmin
    vmin, vmax = float(vmin), float(vmax)
    scale, offset = _scale_range(vmin, vmax, nbins)
    _vmin = vmin - offset
    _vmax = vmax - offset
    steps = _STEPS * scale
    raw_step = (_vmax - _vmin) / nbins
    large = steps >= raw_step
    istep = int(np.nonzero(large)[0][0]) if large.any() else len(steps) - 1
    off = abs(offset)
    for step in steps[:istep + 1][::-1]:
        best_vmin = (_vmin // step) * step
        d, m = divmod(_vmin - best_vmin, step)
        low = d + 1 if _closeto(m / step, 1, off, step) else d
        d, m = divmod(_vmax - best_vmin, step)
        high = d if _closeto(m / step, 0, off, step) else d + 1
        ticks = np.arange(low, high + 1) * step + best_vmin
        nticks = ((ticks <= _vmax) & (ticks >= _vmin)).sum()
        if nticks >= 2:
            break
    return ticks + offset


def _format_ticks(locs: np.ndarray, view: Tuple[float, float]) -> List[str]:
    """ScalarFormatter's labels for locs (offset 0, no order of magnitude,
    which holds for any view that starts at -0.5)."""
    vmin, vmax = sorted(view)
    visible = locs[(vmin <= locs) & (locs <= vmax)]
    if len(visible):
        lmin, lmax = visible.min(), visible.max()
        if not (lmin == lmax or lmin <= 0 <= lmax):
            raise NotImplementedError("a tick offset")
        val = np.abs(visible).max()
        oom = 0 if val == 0 else math.floor(math.log10(val))
        if not -5 < oom < 6:
            raise NotImplementedError("ticks in scientific notation")
    if len(locs) < 2:
        _locs = [*locs, *view]
    else:
        _locs = locs
    arr = (np.asarray(_locs) - 0) / 10. ** 0
    loc_range = np.ptp(arr)
    if loc_range == 0:
        loc_range = np.max(np.abs(arr))
    if loc_range == 0:
        loc_range = 1
    if len(locs) < 2:
        arr = arr[:-2]
    loc_range_oom = int(math.floor(math.log10(loc_range)))
    sigfigs = max(0, 3 - loc_range_oom)
    thresh = 1e-3 * 10 ** loc_range_oom
    while sigfigs >= 0:
        if np.abs(arr - np.round(arr, decimals=sigfigs)).max() < thresh:
            sigfigs -= 1
        else:
            break
    sigfigs += 1
    fmt = f"%1.{sigfigs}f"
    out = []
    for x in locs:
        xp = (x - 0) / (10. ** 0)
        if abs(xp) < 1e-8:
            xp = 0
        # fix_minus: the Unicode minus, which the table lacks (a negative
        # tick is never inside these views)
        out.append((fmt % xp).replace("-", "\u2212"))
    return out


def _ticks_to_draw(locs, view):
    lo, hi = sorted(view)
    rtol = (hi - lo) * 1e-10
    return [lo - rtol <= v <= hi + rtol for v in locs]


# -- the figure ---------------------------------------------------------------

def _grid(ncols: int) -> list:
    """GridSpec(1, ncols).get_grid_positions: each subplot's (x0, y0, x1,
    y1) in figure fractions, the cells' edges summed in order."""
    p = _SUBPLOT
    cell_w = (p["right"] - p["left"]) / (ncols + p["wspace"] * (ncols - 1))
    sep_w = p["wspace"] * cell_w
    bottom = p["top"] - (p["top"] - p["bottom"])
    out, acc = [], 0.0
    for i in range(ncols):
        if i:
            acc += sep_w
        x0 = p["left"] + acc
        acc += cell_w
        out.append((x0, bottom, p["left"] + acc, p["top"]))
    return out


class _Axes:
    """One Axes showing an (h, w) image, its boxes and labels."""

    def __init__(self, w: int, h: int, title: str = ""):
        self.w, self.h = w, h
        self.pos = None         # active position (x0, y0, x1, y1), fractions
        self.title = title
        self.xview = (-0.5, w - 0.5)
        self.yview = (h - 0.5, -0.5)
        self.boxes: list = []   # (rect (x, y, width, height), color)
        self.labels: list = []  # (text, x, y, color)


def _aspect_position(pos0, w, h, fig_aspect):
    """apply_aspect with aspect equal, adjustable box, anchor C."""
    x0, y0, x1, y1 = pos0
    # aspect 1 times the data ratio of the views (-0.5, w - 0.5), (-0.5, h - 0.5)
    box_aspect = 1.0 * (abs((h - 0.5) - (-0.5)) / abs((w - 0.5) - (-0.5)))
    cw, ch = x1 - x0, y1 - y0
    H = cw * box_aspect / fig_aspect
    if H <= ch:
        W = cw
    else:
        W = ch * fig_aspect / box_aspect
        H = ch
    px1, py1 = x0 + W, y0 + H
    L, B, W2, H2 = x0, y0, px1 - x0, py1 - y0
    dx = (x0 + 0.5 * (cw - W2)) - L
    dy = (y0 + 0.5 * (ch - H2)) - B
    return x0 + dx, y0 + dy, px1 + dx, py1 + dy


class _Frame:
    """The figure's transforms at one figure transform: the layout the
    first (tight bbox) draw sees, or the final draw's."""

    def __init__(self, ax: _Axes, fig_t, dpi: float):
        self.ax, self.dpi = ax, dpi
        self.bbox = _transformed(fig_t, *ax.pos)
        self.trans_axes = _bbox_to(*self.bbox)
        lim = _transformed((1.0, 0.0, 1.0, 0.0), ax.xview[0], ax.yview[0],
                           ax.xview[1], ax.yview[1])
        self.trans_data = _compose(_bbox_from(*lim), self.trans_axes)
        # the patch clip box: the unit box through the axes patch
        a = self.trans_axes
        self.clip = (0.0 + a[1], 0.0 + a[3], a[0] + a[1], a[2] + a[3])
        # get_tick_space: the axes' length in points over 3 (x) or 2 (y)
        # label heights, nbins clipped to 1..9
        inv = 1.0 / dpi
        ends_w = (inv * a[0] + inv * a[1]) - inv * a[1]
        ends_h = (inv * a[2] + inv * a[3]) - inv * a[3]
        self.nbins_x = min(max(math.floor(ends_w * 72 / (_TICK_POINTS * 3)),
                               1), 9)
        self.nbins_y = min(max(math.floor(ends_h * 72 / (_TICK_POINTS * 2)),
                               1), 9)
        self.xlocs = _tick_values(*ax.xview, self.nbins_x)
        self.ylocs = _tick_values(*ax.yview, self.nbins_y)
        self.xlabels = _format_ticks(self.xlocs, ax.xview)
        self.ylabels = _format_ticks(self.ylocs, ax.yview)
        self.xdraw = _ticks_to_draw(self.xlocs, ax.xview)
        self.ydraw = _ticks_to_draw(self.ylocs, ax.yview)
        pad = _TICK_SIZE + _TICK_PAD
        d, ta = self.trans_data, self.trans_axes
        # the tick labels' and the title's transforms: blended (or
        # transAxes) + ScaledTranslation by points through dpi_scale_trans
        st = dpi * (-1 * pad / 72)
        self.xtext_t = (d[0], d[1], ta[2], ta[3] + st)
        self.ytext_t = (ta[0], ta[1] + st, d[2], d[3])
        self.title_t = (ta[0], ta[1], ta[2], ta[3] + dpi * (_TITLE_PAD / 72))

    def xticks(self):
        """(loc, label, text, posx, posy) of the x ticks drawn."""
        out = []
        for loc, label, on in zip(self.xlocs, self.xlabels, self.xdraw):
            if on:
                t = _Text(label, _TICK_POINTS, self.dpi, "center", "top")
                px, py = _apply(self.xtext_t, float(loc), 0.0)
                out.append((float(loc), t, px, py))
        return out

    def yticks(self):
        out = []
        for loc, label, on in zip(self.ylocs, self.ylabels, self.ydraw):
            if on:
                t = _Text(label, _TICK_POINTS, self.dpi, "right",
                          "center_baseline")
                px, py = _apply(self.ytext_t, 0.0, float(loc))
                out.append((float(loc), t, px, py))
        return out

    def title(self):
        t = _Text(self.ax.title, _TITLE_POINTS, self.dpi, "center",
                  "baseline")
        px, py = _apply(self.title_t, 0.5, 1.0)
        return t, px, py

    def labels(self):
        out = []
        for text, x, y, color in self.ax.labels:
            t = _Text(text, _LABEL_POINTS, self.dpi, "left", "top")
            px, py = _apply(self.trans_data, x, y)
            out.append((t, px, py, color))
        return out

    def tight(self) -> List[Tuple[float, float, float, float]]:
        """The extents that Axes.get_tightbbox unites."""
        dpi = self.dpi
        bb = []
        # the axes' tick label extents
        for ticks in (self.xticks(), self.yticks()):
            exts = [t.extent(px, py) for _, t, px, py in ticks]
            exts = [e for e in exts if 0 < e[2] - e[0] and 0 < e[3] - e[1]]
            if exts:
                bb.append(_union(exts))
        bb.append(self.bbox)
        if self.ax.title:
            t, px, py = self.title()
            bb.append(t.extent(px, py))
        # children not clipped to the axes: the labels, the axes patch (the
        # axes box again) and the left and bottom spines with their ticks'
        # length
        for t, px, py, _ in self.labels():
            bb.append(t.extent(px, py))
        padout = 1 * _TICK_SIZE / 72 * dpi
        x0, y0, x1, y1 = self._spine_extent("left")
        if any(self.ydraw):
            bb.append((x0 - padout, y0, x1, y1))
        x0, y0, x1, y1 = self._spine_extent("bottom")
        if any(self.xdraw):
            bb.append((x0, y0 - padout, x1, y1))
        return [b for b in bb if (b[2] - b[0]) != 0 or (b[3] - b[1]) != 0]

    def spine(self, which: str):
        """(vertices, matrix) of a spine's path."""
        ax = self.ax
        d, ta = self.trans_data, self.trans_axes
        if which in ("left", "right"):
            x = 0.0 if which == "left" else 1.0
            return ([(x, ax.yview[0]), (x, ax.yview[1])], _matrix2(ta, d))
        y = 0.0 if which == "bottom" else 1.0
        return ([(ax.xview[0], y), (ax.xview[1], y)], _matrix2(d, ta))

    def _spine_extent(self, which: str):
        verts, m = self.spine(which)
        xs = [m[0] * x + m[4] for x, _ in verts]
        ys = [m[3] * y + m[5] for _, y in verts]
        return min(xs), min(ys), max(xs), max(ys)


def _mpl_round(v: float) -> int:
    """mpl_round: half away from zero."""
    return int(math.floor(v + 0.5) if v >= 0 else math.ceil(v - 0.5))


def _union(bbs):
    return (min(b[0] for b in bbs), min(b[1] for b in bbs),
            max(b[2] for b in bbs), max(b[3] for b in bbs))


class _Canvas:
    """An RGBA canvas and the C library's drawing calls on it."""

    def __init__(self, width: float, height: float, dpi: float):
        self.wf, self.hf = width, height
        self.W, self.H = int(width), int(height)
        self.dpi = dpi
        self.px = np.full((self.H, self.W, 4), 255, np.uint8)
        from yolov5m_tpu_torch.data import native
        self.lib = native.plot_lib()

    def path(self, verts, codes, matrix, face, lw, color, cap, clip=None):
        v = np.ascontiguousarray(verts, np.float64)
        c = None if codes is None else np.ascontiguousarray(codes, np.uint8)
        self.lib.plot_path(
            _ptr(self.px), self.W, self.H, ctypes.c_double(self.dpi), _ptr(v),
            None if c is None else _ptr(c), len(v), _dptr(matrix),
            None if face is None else _dptr(face), ctypes.c_double(lw),
            _dptr(color), cap, None if clip is None else _dptr(clip))

    def markers(self, marker, marker_matrix, points, matrix, lw, color):
        m = np.ascontiguousarray(marker, np.float64)
        p = np.ascontiguousarray(points, np.float64)
        self.lib.plot_markers(
            _ptr(self.px), self.W, self.H, ctypes.c_double(self.dpi), _ptr(m),
            len(m), _dptr(marker_matrix), _ptr(p), len(p), _dptr(matrix),
            ctypes.c_double(lw), _dptr(color), 0)

    def text(self, t: _Text, x: float, y: float, color) -> None:
        """Text.draw's line at (x, y) (matplotlib's pixels) through
        RendererAgg.draw_text."""
        y = self.hf - y
        xmin, ymin, _, _ = t.line.bbox
        # the bitmap offset in x, the descent in y; Python's round
        xi = round(x + xmin / 64.0)
        yi = round(y + -ymin / 64.0)
        bm = t.line.bitmap()
        self.lib.plot_text_image(_ptr(self.px), self.W, self.H, _ptr(bm),
                                 bm.shape[1], bm.shape[0], xi, yi + 1,
                                 _dptr(color))

    def image(self, A: np.ndarray, frame: _Frame) -> None:
        """AxesImage.draw: _make_image's resample, then draw_image."""
        h, w = A.shape[:2]
        d = frame.trans_data
        # the image's extent in display pixels, clipped to the axes box
        ext = _transformed(d, -0.5, h - 0.5, w - 0.5, -0.5)
        clip = frame.clip
        cx0 = max(min(ext[0], ext[2]), min(clip[0], clip[2]))
        cx1 = min(max(ext[0], ext[2]), max(clip[0], clip[2]))
        cy0 = max(min(ext[1], ext[3]), min(clip[1], clip[3]))
        cy1 = min(max(ext[1], ext[3]), max(clip[1], clip[3]))
        if not (cx0 <= cx1 and cy0 <= cy1):
            return
        out_w_base = cx1 - cx0
        out_h_base = cy1 - cy0
        if out_w_base == 0 or out_h_base == 0:
            return
        # t: the flip of origin "upper", the extent's box, transData, then
        # the clipped box's corner to 0
        in_w = (w - 0.5) - (-0.5)
        in_h = (-0.5) - (h - 0.5)
        c1 = _compose((in_w / w, -0.5, in_h / h, h - 0.5), d)
        t0 = _compose((1.0, 0.0, -1.0, float(h)), c1)
        t = _compose(t0, (1.0, -cx0, 1.0, -cy0))
        # rounded up to whole pixels, the transform scaled to match
        if out_w_base % 1.0 != 0.0 or out_h_base % 1.0 != 0.0:
            out_w = math.ceil(out_w_base)
            out_h = math.ceil(out_h_base)
            ew = (out_w - out_w_base) / out_w_base
            eh = (out_h - out_h_base) / out_h_base
            t = _compose(t, (1.0 + ew, 0.0, 1.0 + eh, 0.0))
        else:
            out_w, out_h = int(out_w_base), int(out_h_base)
        # imshow's interpolation "auto": nearest past 3x, or at 1x or 2x
        x_a, y_a = _apply(t, 0.0, 0.0)
        x_b, y_b = _apply(t, float(w), float(h))
        dispx, dispy = abs(x_b - x_a), abs(y_b - y_a)
        nearest = ((dispx > 3 * w or dispx == w or dispx == 2 * w) and
                   (dispy > 3 * h or dispy == h or dispy == 2 * h))
        f64 = A.dtype == np.float64
        rgba = np.zeros((h, w, 4), A.dtype)
        rgba[..., :3] = A
        rgba[..., 3] = 1.0
        out = np.zeros((out_h, out_w, 4), A.dtype)
        self.lib.plot_resample(_ptr(rgba), w, h, _ptr(out), out_w, out_h,
                               _dptr(_matrix(t)), int(not nearest), int(f64))
        out[..., 3] = 1.0
        img = (out * 255).astype(np.uint8)
        x = _mpl_round(cx0)
        y = _mpl_round(self.H - (cy0 + out_h))
        self.lib.plot_blend_image(_ptr(self.px), self.W, self.H,
                                  _ptr(np.ascontiguousarray(img)), out_w,
                                  out_h, x, y, _dptr(frame.clip))


def _draw_axes(cv: _Canvas, frame: _Frame, image: np.ndarray) -> None:
    """Axes.draw: the artists in zorder, as matplotlib draws them."""
    ax, dpi = frame.ax, frame.dpi
    cv.image(image, frame)
    unit = [(0, 0), (1, 0), (1, 1), (0, 1), (0, 0)]
    closed = [1, 2, 2, 2, _CLOSEPOLY]
    for (x, y, bw, bh), color in ax.boxes:
        # Rectangle: BboxTransformTo of its extents, then transData
        x1, y1 = x + bw, y + bh
        bt = _bbox_to(x, y, x1, y1)
        m = _compose(bt, frame.trans_data)
        cv.path(unit, closed, _matrix(m), None, _BOX_WIDTH, color, 0,
                frame.clip)
    size = _TICK_SIZE * dpi / 72
    d, ta = frame.trans_data, frame.trans_axes
    for loc, t, px, py in frame.xticks():
        cv.markers([(-0.0, 0.0), (-0.0, 1.0)],
                   (size, -0.0, 0.0, -size, 0.0, -0.0), [(loc, 0.0)],
                   _matrix2(d, ta), _TICK_WIDTH, _BLACK)
        cv.text(t, t.line_xy[0] + px, t.line_xy[1] + py, _BLACK)
    for loc, t, px, py in frame.yticks():
        cv.markers([(0.0, 0.0), (1.0, 0.0)],
                   (-size, 0.0, -0.0, size, -0.0, 0.0), [(0.0, loc)],
                   _matrix2(ta, d), _TICK_WIDTH, _BLACK)
        cv.text(t, t.line_xy[0] + px, t.line_xy[1] + py, _BLACK)
    for which in ("left", "right", "bottom", "top"):
        verts, m = frame.spine(which)
        cv.path(verts, None, m, None, _SPINE_WIDTH, _BLACK, 1)
    for t, px, py, color in frame.labels():
        x_box, y_box, w_box, h_box = t.textbox()
        m = (1.0, 0.0, 0.0, 1.0, px + x_box, py + y_box)
        cv.path([(0.0, 0.0), (w_box, 0.0), (w_box, h_box), (0.0, h_box),
                 (0.0, 0.0)], closed, m, color, _LABEL_EDGE, color, 0)
        cv.text(t, t.line_xy[0] + px, t.line_xy[1] + py, _WHITE)
    if ax.title:
        t, px, py = frame.title()
        cv.text(t, t.line_xy[0] + px, t.line_xy[1] + py, _BLACK)


def _colors(n: int):
    """tab20b at np.linspace(0, 1, n): ListedColormap's lookup."""
    n = max(n, 1)
    out = []
    for i in range(n):
        v = 1.0 if (i == n - 1 and n > 1) else (i * (1.0 / (n - 1)) if n > 1
                                                 else 0.0)
        k = v * 20
        k = 19 if k == 20 else int(k)
        out.append((*_TAB20B[k], 1.0))
    return out


def draw_boxes(ax: "_Axes", image: np.ndarray, rows: np.ndarray,
               labels: Sequence[str], with_conf: bool = True) -> None:
    """Adds an image's rows ((n, 6) class, conf, x1, y1, x2, y2 in pixels)
    to an axes of the figure: a box and a label each, in tab20b."""
    colors = _colors(len(labels))
    h, w = image.shape[:2]
    for row in rows:
        cls = int(row[0])
        x1 = float(np.clip(row[2], 0, w))
        y1 = float(np.clip(row[3], 0, h))
        x2 = float(np.clip(row[4], 0, w))
        y2 = float(np.clip(row[5], 0, h))
        color = colors[cls % len(colors)]
        ax.boxes.append(((x1, y1, x2 - x1, y2 - y1), color))
        text = labels[cls] if cls < len(labels) else str(cls)
        if with_conf:
            text = f"{text}: {row[1]:.2f}"
        if _is_math(text):
            raise ValueError(f"{text!r} would be mathtext")
        ax.labels.append((text, x1, y1, color))


def _render(axes: List[_Axes], images: List[np.ndarray], figsize,
            dpi: float, fig_positions) -> np.ndarray:
    """Figure.savefig(dpi, bbox_inches="tight") of the figure: the RGBA
    canvas."""
    fw, fh = figsize
    fig_w, fig_h = dpi * fw, dpi * fh
    fig_t = (fig_w, 0.0, fig_h, 0.0)
    fig_aspect = fig_h / fig_w
    for ax, pos0 in zip(axes, fig_positions):
        ax.pos = _aspect_position(pos0, ax.w, ax.h, fig_aspect)
    # the first draw: the tight bbox, in inches, padded
    bb = []
    for ax in axes:
        frame = _Frame(ax, fig_t, dpi)
        ext = frame.tight()
        bb.append(_union(ext))
    px0, py0, px1, py1 = _union(bb)
    inv = 1.0 / dpi
    ix0, iy0 = inv * px0 - _PAD_INCHES, inv * py0 - _PAD_INCHES
    ix1, iy1 = inv * px1 + _PAD_INCHES, inv * py1 + _PAD_INCHES
    # adjust_bbox: the figure moved by the bbox's corner (transFigure's
    # box from_bounds(-x0, -y0, fig_w, fig_h)), the canvas the bbox's size
    bx0, by0 = -(dpi * ix0), -(dpi * iy0)
    fig_t2 = ((bx0 + fig_w) - bx0, bx0, (by0 + fig_h) - by0, by0)
    cv = _Canvas(dpi * (ix1 - ix0), dpi * (iy1 - iy0), dpi)
    for ax, img in zip(axes, images):
        _draw_axes(cv, _Frame(ax, fig_t2, dpi), img)
    return cv.px


def _image_array(image: np.ndarray) -> np.ndarray:
    """imshow's np.clip(image, 0, 1) of a float32 or float64 (h, w, 3)
    image; imshow resamples in the image's float type (other types take
    paths the port does not draw)."""
    a = np.clip(image, 0, 1)
    if a.dtype not in (np.float32, np.float64) or a.ndim != 3 \
            or a.shape[2] != 3:
        raise ValueError(f"expected a float32 or float64 (h, w, 3) image, "
                         f"got {a.dtype} {a.shape}")
    return np.ascontiguousarray(a)


def write_png(path: str, rgba: np.ndarray, dpi: float) -> None:
    """An 8-bit RGBA PNG with matplotlib's tEXt "Software" and pHYs."""
    h, w = rgba.shape[:2]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body +
                struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    raw = np.zeros((h, w * 4 + 1), np.uint8)
    raw[:, 1:] = np.ascontiguousarray(rgba, np.uint8).reshape(h, w * 4)
    data = zlib.compress(raw.tobytes(), 6)
    ppm = int(dpi / 0.0254 + 0.5)
    out = [b"\x89PNG\r\n\x1a\n",
           chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)),
           chunk(b"tEXt", b"Software\x00" + _SOFTWARE),
           chunk(b"pHYs", struct.pack(">IIB", ppm, ppm, 1))]
    for i in range(0, len(data), 65536):
        out.append(chunk(b"IDAT", data[i:i + 65536]))
    out.append(chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"".join(out))


def render_image(image: np.ndarray, rows: np.ndarray,
                 labels: Sequence[str] = COCO_LABELS) -> np.ndarray:
    """The RGBA canvas that plot_image saves."""
    img = _image_array(image)
    h, w = img.shape[:2]
    ax = _Axes(w, h)
    draw_boxes(ax, img, rows, labels, with_conf=True)
    return _render([ax], [img], (6.4, 4.8), 200.0, _grid(1))


def render_prediction(image: np.ndarray, pred: np.ndarray, gt: np.ndarray,
                      labels: Sequence[str] = COCO_LABELS) -> np.ndarray:
    """The RGBA canvas of one save_prediction_images file."""
    img = _image_array(image)
    h, w = img.shape[:2]
    ax1 = _Axes(w, h, "Ground Truth bboxes")
    ax2 = _Axes(w, h, "Predicted bboxes")
    draw_boxes(ax1, img, gt, labels, with_conf=False)
    draw_boxes(ax2, img, pred, labels, with_conf=True)
    return _render([ax1, ax2], [img, img], (10.0, 5.0), 150.0, _grid(2))


def plot_image(image: np.ndarray, rows: np.ndarray,
               labels: Sequence[str] = COCO_LABELS,
               save_path: Optional[str] = None) -> np.ndarray:
    """One image in [0, 1] with its detections (rows: (n, 6) class, conf,
    x1, y1, x2, y2 in pixels), saved to ``save_path`` at 200 dpi with a
    tight bbox when given. Returns the RGBA canvas."""
    rgba = render_image(image, rows, labels)
    if save_path:
        write_png(save_path, rgba, 200.0)
    return rgba


def save_prediction_images(images: np.ndarray,
                           pred_rows: Iterable[np.ndarray],
                           gt_rows: Iterable[np.ndarray], folder: str,
                           filename: str, epoch: int,
                           labels: Sequence[str] = COCO_LABELS,
                           num_images: int = 5) -> int:
    """Side-by-side GT and prediction images in
    {folder}/{filename}/EPOCH_{epoch}/image_{i}.png. Returns the number of
    files written."""
    path = os.path.join(folder, filename, f"EPOCH_{epoch}")
    os.makedirs(path, exist_ok=True)
    written = 0
    for idx, (img, pr, gt) in enumerate(zip(images, pred_rows, gt_rows)):
        if idx >= num_images:
            break
        rgba = render_prediction(img, pr, gt, labels)
        write_png(os.path.join(path, f"image_{idx}.png"), rgba, 150.0)
        written += 1
    return written
