"""Host-side training augmentations: numpy and the port's C image ops.

Port of ``yolov5m_tpu/data/augment.py``: the reference's TRAIN_TRANSFORMS
pipeline (ColorJitter 0.2/0.2/0.2 p .4, Transpose on even batches,
HorizontalFlip .5, VerticalFlip .5, Rotate +-20 p .7, Blur p .05, CLAHE
p .1, Posterize p .1, ChannelShuffle p .05, min-visibility 0.4), HSV gains
and mosaic-4. Labels are (n, 5) rows (class, cx, cy, w, h), normalized.

Rotate, blur, CLAHE, the HSV and Lab conversions and the mosaic's 2x
downscale are the C ops of ``csrc/augment.cc`` (through ``data/native.py``),
which compute what the JAX package's cv2 calls compute, bit for bit.
They run on every machine, and the random draws are the JAX package's
with cv2. Where the C library cannot be built, a TrainAugment that may
rotate, blur or apply CLAHE, augment_hsv and mosaic4 raise.

``calls`` counts each op's runs (rotate, blur, clahe, hsv, downscale).
"""

from __future__ import annotations

import math
import threading

import numpy as np

from yolov5m_tpu_torch.data import native

MIN_VISIBILITY = 0.4
# HSV gains, Ultralytics hyp.scratch defaults (host and device)
HGAIN, SGAIN, VGAIN = 0.015, 0.7, 0.4

calls = {"rotate": 0, "blur": 0, "clahe": 0, "hsv": 0, "downscale": 0}
_calls_lock = threading.Lock()


def _count(op: str) -> None:
    with _calls_lock:
        calls[op] += 1


def reset_calls() -> None:
    """Set every op's count to 0."""
    with _calls_lock:
        for op in calls:
            calls[op] = 0


def rotation_matrix(center, angle: float, scale: float = 1.0) -> np.ndarray:
    """cv2.getRotationMatrix2D(center, angle, scale): the 2x3 forward
    matrix, in double, by cv2's formula (the center in float32, the C
    library's cos and sin)."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = (float(np.float32(c)) for c in center)
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _boxes_to_corners(labels: np.ndarray) -> np.ndarray:
    """(n, 5) -> (n, 4) normalized xyxy."""
    cx, cy, w, h = labels[:, 1], labels[:, 2], labels[:, 3], labels[:, 4]
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 1)


def _corners_to_boxes(cls: np.ndarray, c: np.ndarray) -> np.ndarray:
    return np.stack([cls, (c[:, 0] + c[:, 2]) / 2, (c[:, 1] + c[:, 3]) / 2,
                     c[:, 2] - c[:, 0], c[:, 3] - c[:, 1]], 1)


def _clip_and_filter(cls, corners, orig_area, min_vis=MIN_VISIBILITY):
    clipped = np.clip(corners, 0.0, 1.0)
    area = np.maximum(clipped[:, 2] - clipped[:, 0], 0) * \
        np.maximum(clipped[:, 3] - clipped[:, 1], 0)
    keep = area / np.maximum(orig_area, 1e-9) >= min_vis
    return cls[keep], clipped[keep]


class TrainAugment:
    """Callable (image float32 HWC [0, 255], labels (n, 5), batch_idx,
    rng) -> (image, labels). Pass a per-item ``rng`` from loader threads:
    the shared ``self.rng`` is not thread-safe."""

    def __init__(self, seed: int = 0,
                 color_jitter_p: float = 0.4,
                 hflip_p: float = 0.5, vflip_p: float = 0.5,
                 rotate_p: float = 0.7, rotate_limit: float = 20.0,
                 blur_p: float = 0.05, clahe_p: float = 0.1,
                 posterize_p: float = 0.1, channel_shuffle_p: float = 0.05,
                 transpose_batch_parity: bool = True):
        self.rng = np.random.default_rng(seed)
        self.color_jitter_p = color_jitter_p
        self.hflip_p = hflip_p
        self.vflip_p = vflip_p
        self.rotate_p = rotate_p
        self.rotate_limit = rotate_limit
        self.blur_p = blur_p
        self.clahe_p = clahe_p
        self.posterize_p = posterize_p
        self.channel_shuffle_p = channel_shuffle_p
        self.transpose_batch_parity = transpose_batch_parity
        if max(rotate_p, blur_p, clahe_p) > 0:
            native.augment_lib()

    def __call__(self, img: np.ndarray, labels: np.ndarray, batch_idx: int = 0,
                 rng: np.random.Generator = None):
        r = rng if rng is not None else self.rng
        labels = labels.copy()
        cls = labels[:, 0] if len(labels) else np.zeros((0,))
        corners = _boxes_to_corners(labels) if len(labels) else np.zeros((0, 4))

        if r.random() < self.color_jitter_p:
            img = self._color_jitter(img, r)

        # transpose: on even batches only (the reference toggles its p by
        # batch parity)
        if self.transpose_batch_parity and batch_idx % 2 == 0 \
                and img.shape[0] == img.shape[1]:
            img = np.ascontiguousarray(np.transpose(img, (1, 0, 2)))
            corners = corners[:, [1, 0, 3, 2]] if len(corners) else corners

        if r.random() < self.hflip_p:
            img = np.ascontiguousarray(img[:, ::-1])
            if len(corners):
                corners = np.stack([1 - corners[:, 2], corners[:, 1],
                                    1 - corners[:, 0], corners[:, 3]], 1)
        if r.random() < self.vflip_p:
            img = np.ascontiguousarray(img[::-1])
            if len(corners):
                corners = np.stack([corners[:, 0], 1 - corners[:, 3],
                                    corners[:, 2], 1 - corners[:, 1]], 1)

        if r.random() < self.rotate_p:
            angle = r.uniform(-self.rotate_limit, self.rotate_limit)
            img, cls, corners = self._rotate(img, cls, corners, angle)

        if r.random() < self.blur_p:
            k = int(r.integers(3, 8)) | 1
            _count("blur")
            img = native.box_blur(img, k)
        if r.random() < self.clahe_p:
            img = self._clahe(img)
        if r.random() < self.posterize_p:
            bits = int(r.integers(4, 8))
            shift = 8 - bits
            img = ((img.astype(np.uint8) >> shift) << shift).astype(np.float32)
        if r.random() < self.channel_shuffle_p:
            img = img[..., r.permutation(3)]

        if len(corners):
            labels = _corners_to_boxes(cls, corners).astype(np.float32)
        else:
            labels = np.zeros((0, 5), np.float32)
        return np.ascontiguousarray(img, dtype=np.float32), labels

    @staticmethod
    def _color_jitter(img, r, limit=0.2, factors=None):
        """Brightness, contrast (about the global mean after brightness),
        saturation (about the per-pixel channel mean), one clip at the end.
        factors: explicit (brightness, contrast, saturation)."""
        fb, fc, fs = (factors if factors is not None else
                      r.uniform(1 - limit, 1 + limit, 3))
        img = img.astype(np.float32)
        img = img * fb
        mean = img.mean()
        img = (img - mean) * fc + mean
        gray = img.mean(axis=-1, keepdims=True)
        img = (img - gray) * fs + gray
        return np.clip(img, 0, 255)

    def _rotate(self, img, cls, corners, angle):
        h, w = img.shape[:2]
        m = rotation_matrix((w / 2, h / 2), angle)
        _count("rotate")
        img = native.warp_affine(img, m, (w, h))
        if not len(corners):
            return img, cls, corners
        pts = corners * np.array([w, h, w, h])
        quads = np.stack([pts[:, [0, 1]], pts[:, [2, 1]],
                          pts[:, [2, 3]], pts[:, [0, 3]]], axis=1)  # (n,4,2)
        ones = np.ones((*quads.shape[:2], 1))
        rot = np.concatenate([quads, ones], -1) @ m.T                # (n,4,2)
        new = np.stack([rot[..., 0].min(1), rot[..., 1].min(1),
                        rot[..., 0].max(1), rot[..., 1].max(1)], 1)
        new = new / np.array([w, h, w, h])
        # visibility is measured against the rotated (unclipped) hull, as
        # albumentations does and as ops/augment_device.py does
        area = np.maximum(new[:, 2] - new[:, 0], 0) * np.maximum(new[:, 3] - new[:, 1], 0)
        cls, new = _clip_and_filter(cls, new, area)
        return img, cls, new

    @staticmethod
    def _clahe(img):
        """CLAHE (clip 4, 8 x 8 tiles) of the Lab lightness."""
        _count("clahe")
        lab = native.rgb_to_lab(np.clip(img, 0, 255).astype(np.uint8))
        lab[..., 0] = native.clahe(lab[..., 0], 4.0, (8, 8))
        return native.lab_to_rgb(lab).astype(np.float32)


def augment_hsv(img: np.ndarray, rng: np.random.Generator,
                hgain: float = HGAIN, sgain: float = SGAIN,
                vgain: float = VGAIN, gains: np.ndarray = None) -> np.ndarray:
    """Random HSV gains (Ultralytics hyp.scratch defaults) through the
    uint8 HSV of cv2 (hue 0..180) and lookup tables. gains: explicit
    (r_h, r_s, r_v)."""
    r = gains if gains is not None \
        else rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    _count("hsv")
    hsv = native.rgb_to_hsv(np.clip(img, 0, 255).astype(np.uint8))
    x = np.arange(256)
    lut_h = ((x * r[0]) % 180).astype(np.uint8)
    lut_s = np.clip(x * r[1], 0, 255).astype(np.uint8)
    lut_v = np.clip(x * r[2], 0, 255).astype(np.uint8)
    merged = np.stack([lut_h[hsv[..., 0]], lut_s[hsv[..., 1]],
                       lut_v[hsv[..., 2]]], -1)
    return native.hsv_to_rgb(merged).astype(np.float32)


def mosaic4(items, out_size: int, rng: np.random.Generator,
            fill: float = 114.0, center=None):
    """Four (image, labels) pairs -> one out_size x out_size mosaic: a 2s
    canvas with a jittered center, one image per quadrant, downscaled to s
    (cv2's INTER_LINEAR at 0.5: each pixel lerps its 2x2 block); labels
    shifted, clipped and min-visibility filtered. center: explicit
    (yc, xc)."""
    s = out_size
    canvas = np.full((2 * s, 2 * s, 3), fill, np.float32)
    if center is not None:
        yc, xc = int(center[0]), int(center[1])
    else:
        yc = int(rng.integers(s // 2, 3 * s // 2))
        xc = int(rng.integers(s // 2, 3 * s // 2))
    out_cls, out_corners, out_area = [], [], []

    for k, (img, labels) in enumerate(items):
        h, w = img.shape[:2]
        if k == 0:   # top-left: bottom-right corner at (xc, yc)
            x1a, y1a = max(xc - w, 0), max(yc - h, 0)
            x2a, y2a = xc, yc
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
        elif k == 1:  # top-right
            x1a, y1a = xc, max(yc - h, 0)
            x2a, y2a = min(xc + w, 2 * s), yc
            x1b, y1b = 0, h - (y2a - y1a)
        elif k == 2:  # bottom-left
            x1a, y1a = max(xc - w, 0), yc
            x2a, y2a = xc, min(yc + h, 2 * s)
            x1b, y1b = w - (x2a - x1a), 0
        else:         # bottom-right
            x1a, y1a = xc, yc
            x2a, y2a = min(xc + w, 2 * s), min(yc + h, 2 * s)
            x1b, y1b = 0, 0
        x2b, y2b = x1b + (x2a - x1a), y1b + (y2a - y1a)
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]

        if len(labels):
            c = _boxes_to_corners(labels) * np.array([w, h, w, h])
            c += np.array([x1a - x1b, y1a - y1b, x1a - x1b, y1a - y1b])
            area = np.maximum(c[:, 2] - c[:, 0], 0) * \
                np.maximum(c[:, 3] - c[:, 1], 0)
            out_cls.append(labels[:, 0])
            out_corners.append(c)
            out_area.append(area)

    _count("downscale")
    img_out = native.downscale2x(canvas)
    if not out_cls:
        return img_out, np.zeros((0, 5), np.float32)

    cls = np.concatenate(out_cls)
    corners = np.concatenate(out_corners) / (2 * s)   # normalize to canvas
    area = np.concatenate(out_area) / (2 * s) ** 2
    cls, corners = _clip_and_filter(cls, corners, area)
    if not len(cls):
        return img_out, np.zeros((0, 5), np.float32)
    return img_out, _corners_to_boxes(cls, corners).astype(np.float32)
