"""Photometric and geometric train augmentations on the device.

Port of ``yolov5m_tpu/ops/augment_device.py``, batched over (B, H, W, 3)
images in [0, 1]:

  * HSV gain jitter with the host augment_hsv's semantics in float: hue in
    OpenCV's 0..180 scale times r_h, wrapped mod 180; S and V scaled and
    clipped. The host quantizes through uint8 tables, so the two agree to
    uint8 rounding;
  * color jitter with TrainAugment._color_jitter's math: brightness,
    contrast about the image mean (after brightness), saturation about the
    per-pixel channel mean, one clip. Scale-invariant, so [0, 1] here is
    the host's [0, 255] / 255;
  * horizontal and vertical flips, cx' = 1 - cx and cy' = 1 - cy on the
    valid label rows;
  * rotation about the (w/2, h/2) pixel point, bilinear with a zero border
    (cv2.warpAffine's convention), labels as the clipped hull of the
    rotated corners, masked out below min-visibility. Not in the train
    CLI's --device_augment set: the host keeps rotate, as in the JAX
    package.

Each random op has an entry point that takes its draws (gains, factors,
angles, flip booleans), so that tests can feed both packages the same
values; ``device_augment_batch`` draws them from a ``torch.Generator`` and
applies mosaic -> HSV -> color jitter -> flips -> rotate, the host
pipeline's order.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from yolov5m_tpu_torch.data.augment import (HGAIN, MIN_VISIBILITY, SGAIN,
                                            VGAIN)
from yolov5m_tpu_torch.ops.mosaic import FILL, random_mosaic_batch


def _bcast(values: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) per-image values shaped to broadcast against ``like`` (B, ...)."""
    return values.reshape(-1, *([1] * (like.dim() - 1)))


def rgb_to_hsv(img: torch.Tensor):
    """RGB [0, 1] -> (h in degrees [0, 360), s [0, 1], v [0, 1]), OpenCV's
    piecewise hue."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    safe_c = torch.where(c > 0, c, torch.ones_like(c))
    h = torch.where(
        c <= 0, torch.zeros_like(c),
        torch.where(v == r, torch.remainder((g - b) / safe_c, 6.0),
                    torch.where(v == g, (b - r) / safe_c + 2.0,
                                (r - g) / safe_c + 4.0)))
    s = torch.where(v > 0, c / torch.where(v > 0, v, torch.ones_like(v)),
                    torch.zeros_like(v))
    return h * 60.0, s, v


def hsv_to_rgb(h_deg: torch.Tensor, s: torch.Tensor, v: torch.Tensor):
    """Inverse of rgb_to_hsv by sector."""
    h6 = torch.remainder(h_deg / 60.0, 6.0)
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32)

    def sector(*vals):
        """vals[k] where i == k for k < 5, else vals[5]."""
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([sector(v, q, p, p, t, v), sector(t, v, v, q, p, p),
                        sector(p, p, t, v, v, q)], -1)


def hsv_jitter(images: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """Per-image (r_h, r_s, r_v) gains (B, 3) on (B, H, W, 3) images in
    [0, 1]."""
    h_deg, s, v = rgb_to_hsv(images)
    g = gains.to(images.dtype)
    h_cv = h_deg * 0.5                       # OpenCV's uint8 hue (0..180)
    h_cv = torch.remainder(h_cv * _bcast(g[:, 0], h_cv), 180.0)
    s = (s * _bcast(g[:, 1], s)).clamp(0.0, 1.0)
    v = (v * _bcast(g[:, 2], v)).clamp(0.0, 1.0)
    return hsv_to_rgb(h_cv * 2.0, s, v).to(images.dtype)


def color_jitter(images: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Per-image (brightness, contrast, saturation) factors (B, 3) on
    (B, H, W, 3) images in [0, 1]."""
    fb, fc, fs = factors.to(images.dtype)[:, None, None, None, :].unbind(-1)
    img = images * fb
    mean = img.mean(dim=(1, 2, 3), keepdim=True)
    img = (img - mean) * fc + mean
    gray = img.mean(dim=-1, keepdim=True)
    img = (img - gray) * fs + gray
    return img.clamp(0.0, 1.0)


def _rotation(angle_deg: torch.Tensor, w: int, h: int):
    """(a, b, tx, ty) per image of cv2.getRotationMatrix2D((w/2, h/2),
    angle, 1): the affine [[a, b, tx], [-b, a, ty]] from source to
    destination pixels."""
    rad = angle_deg * (math.pi / 180.0)
    a, b = torch.cos(rad), torch.sin(rad)
    cx, cy = w / 2.0, h / 2.0
    return a, b, (1 - a) * cx - b * cy, b * cx + (1 - a) * cy


def rotate_image(images: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate each (H, W, C) image by angles[i] degrees about the (w/2, h/2)
    pixel point, bilinear, zero border: dst(x, y) = src(M^-1 (x, y, 1)),
    pixel centers at integer coordinates."""
    bsz, h, w, c = images.shape
    dev = images.device
    a, b, tx, ty = (t.to(torch.float32)[:, None, None]
                    for t in _rotation(angles, w, h))
    dy, dx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    ux, uy = dx[None] - tx, dy[None] - ty
    sx = a * ux - b * uy                       # the inverse rotation (A^T)
    sy = b * ux + a * uy
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    flat = images.reshape(-1, c)
    base = (torch.arange(bsz, device=dev) * (h * w))[:, None, None]

    def tap(yi, xi):
        valid = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h))[..., None]
        px = flat[(base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
                  .reshape(-1)].reshape(bsz, h, w, c)
        return torch.where(valid, px, torch.zeros((), dtype=px.dtype,
                                                  device=dev))

    top = tap(y0i, x0i) * (1 - fx) + tap(y0i, x0i + 1) * fx
    bot = tap(y0i + 1, x0i) * (1 - fx) + tap(y0i + 1, x0i + 1) * fx
    return (top * (1 - fy) + bot * fy).to(images.dtype)


def rotate_labels(labels: torch.Tensor, mask: torch.Tensor,
                  angles: torch.Tensor, w: int, h: int,
                  min_visibility: float = MIN_VISIBILITY):
    """TrainAugment._rotate's label math on padded (B, nb, 5) labels: box
    corners through the forward affine, their axis-aligned hull, clipped to
    [0, 1], kept iff clipped area / hull area >= min_visibility (dropped
    rows become mask False)."""
    a, b, tx, ty = (t[:, None, None] for t in _rotation(angles, w, h))
    cx, cy, bw, bh = (labels[..., 1], labels[..., 2], labels[..., 3],
                      labels[..., 4])
    x1, y1 = (cx - bw / 2) * w, (cy - bh / 2) * h
    x2, y2 = (cx + bw / 2) * w, (cy + bh / 2) * h
    qx = torch.stack([x1, x2, x2, x1], -1)           # (B, nb, 4)
    qy = torch.stack([y1, y1, y2, y2], -1)
    rx = a * qx + b * qy + tx
    ry = -b * qx + a * qy + ty
    nx1, nx2 = rx.amin(-1) / w, rx.amax(-1) / w
    ny1, ny2 = ry.amin(-1) / h, ry.amax(-1) / h
    hull_area = (nx2 - nx1).clamp(min=0) * (ny2 - ny1).clamp(min=0)
    cx1, cy1 = nx1.clamp(0.0, 1.0), ny1.clamp(0.0, 1.0)
    cx2, cy2 = nx2.clamp(0.0, 1.0), ny2.clamp(0.0, 1.0)
    clip_area = (cx2 - cx1).clamp(min=0) * (cy2 - cy1).clamp(min=0)
    keep = clip_area / hull_area.clamp(min=1e-9) >= min_visibility
    new = torch.stack([labels[..., 0], (cx1 + cx2) / 2, (cy1 + cy2) / 2,
                       cx2 - cx1, cy2 - cy1], -1)
    return new, mask & keep


def rotate_batch(images, labels, mask, do: torch.Tensor,
                 angles: torch.Tensor, min_visibility: float = MIN_VISIBILITY):
    """Rotate the rows where ``do`` (B,) is True by ``angles`` (B,)
    degrees, images and labels."""
    h, w = images.shape[1], images.shape[2]
    imgs = torch.where(do[:, None, None, None],
                       rotate_image(images, angles), images)
    rot_lab, rot_mask = rotate_labels(labels, mask, angles, w, h,
                                      min_visibility)
    return (imgs, torch.where(do[:, None, None], rot_lab, labels),
            torch.where(do[:, None], rot_mask, mask))


def flip_batch(images, labels, mask, do_h: torch.Tensor, do_v: torch.Tensor):
    """Mirror the rows where do_h (B,) is True left-right and those where
    do_v is True top-bottom; labels of valid rows follow (cx' = 1 - cx,
    cy' = 1 - cy), padded rows stay untouched."""
    imgs = torch.where(do_h[:, None, None, None], images.flip(2), images)
    imgs = torch.where(do_v[:, None, None, None], imgs.flip(1), imgs)
    cx = torch.where(do_h[:, None], 1.0 - labels[..., 1], labels[..., 1])
    cy = torch.where(do_v[:, None], 1.0 - labels[..., 2], labels[..., 2])
    new = torch.stack([labels[..., 0], cx, cy, labels[..., 3],
                       labels[..., 4]], -1)
    return imgs, torch.where(mask[..., None], new, labels), mask


def device_augment_batch(generator: Optional[torch.Generator], images,
                         labels, mask, *, mosaic_p: float = 0.0,
                         hsv: bool = True, hflip_p: float = 0.5,
                         vflip_p: float = 0.5, hgain: float = HGAIN,
                         sgain: float = SGAIN, vgain: float = VGAIN,
                         cj_p: float = 0.0, cj_limit: float = 0.2,
                         rotate_p: float = 0.0, rotate_limit: float = 20.0,
                         min_visibility: float = MIN_VISIBILITY,
                         fill: float = FILL):
    """The train step's device augmentation, draws from ``generator`` (on
    the images' device): mosaic -> HSV -> color jitter -> flips -> rotate.

    images (B, s, s, 3) float in [0, 1]; labels (B, nb, 5); mask (B, nb).
    Returns (images, labels, mask)."""
    b = images.shape[0]
    kw = dict(generator=generator, device=images.device)
    if mosaic_p > 0.0:
        images, labels, mask = random_mosaic_batch(
            generator, images, labels, mask, mosaic_p, min_visibility, fill)
    if hsv:
        u = torch.rand((b, 3), **kw) * 2.0 - 1.0
        gains = u * torch.tensor([hgain, sgain, vgain],
                                 device=images.device) + 1.0
        images = hsv_jitter(images, gains)
    if cj_p > 0.0:
        do = torch.rand((b,), **kw) < cj_p
        factors = (1.0 - cj_limit) + 2 * cj_limit * torch.rand((b, 3), **kw)
        images = torch.where(do[:, None, None, None],
                             color_jitter(images, factors), images)
    if hflip_p > 0.0 or vflip_p > 0.0:
        do_h = torch.rand((b,), **kw) < hflip_p
        do_v = torch.rand((b,), **kw) < vflip_p
        images, labels, mask = flip_batch(images, labels, mask, do_h, do_v)
    if rotate_p > 0.0:
        do = torch.rand((b,), **kw) < rotate_p
        angles = (2 * torch.rand((b,), **kw) - 1) * rotate_limit
        images, labels, mask = rotate_batch(images, labels, mask, do, angles,
                                            min_visibility)
    return images, labels, mask
