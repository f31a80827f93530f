"""Device-side preprocessing: port of ``yolov5m_tpu/ops/preprocess.py``.

uint8 frames go to the device once; normalize (and, for
``letterbox_normalize``, resize and pad) run there. The letterbox geometry
is an own copy of the JAX package's (which matches the host letterbox in
``data/native.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def letterbox_geometry(src_hw: Tuple[int, int], dst_hw: Tuple[int, int],
                       scaleup: bool = True):
    """Static letterbox geometry: (ratio, (dw, dh), (top, left), (uh, uw))."""
    sh, sw = src_hw
    nh, nw = dst_hw
    r = min(nh / sh, nw / sw)
    if not scaleup:
        r = min(r, 1.0)
    uw, uh = int(round(sw * r)), int(round(sh * r))
    dw, dh = (nw - uw) / 2, (nh - uh) / 2
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    return r, (dw, dh), (top, left), (uh, uw)


def normalize_uint8(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [0, 255] -> ``dtype`` [0, 1], converting before dividing, in
    the target dtype. In bf16 the quotient equals bf16(f32(u) / 255) for all
    256 codes, so it does not matter which side normalizes. The divisor is
    a device tensor: CUDA turns a division by a host scalar into a multiply
    by its reciprocal, which rounds differently."""
    return x.to(dtype) / torch.full((), 255.0, dtype=dtype, device=x.device)


def _bilinear_axis_tables(src: int, dst: int):
    """Half-pixel-center bilinear gather indices and weights (numpy, the
    JAX package's tables): no antialiasing, indices clipped to [0, src-1]."""
    f = np.clip((np.arange(dst) + 0.5) * src / dst - 0.5, 0, src - 1)
    i0 = f.astype(np.int64)
    i1 = np.minimum(i0 + 1, src - 1)
    t = (f - i0).astype(np.float32)
    return i0, i1, t


def letterbox_normalize(images: torch.Tensor,
                        out_hw: Tuple[int, int] = (640, 640),
                        fill: int = 114, scaleup: bool = True) -> torch.Tensor:
    """(bs, H, W, 3) uint8/float [0, 255] -> (bs, out_h, out_w, 3) float32
    [0, 1]: bilinear resize to the aspect-preserving size, rounded as the
    host uint8 pipeline rounds (floor(clip(x, 0, 255) + 0.5)), then padded
    with ``fill``."""
    bs, sh, sw, c = images.shape
    nh, nw = out_hw
    _, _, (top, left), (uh, uw) = letterbox_geometry((sh, sw), (nh, nw),
                                                     scaleup)
    dev = images.device
    x = images.float()
    if (uh, uw) != (sh, sw):
        y0, y1, ty = _bilinear_axis_tables(sh, uh)
        x0, x1, tx = _bilinear_axis_tables(sw, uw)
        y0, y1, x0, x1 = (torch.from_numpy(a).to(dev) for a in (y0, y1, x0, x1))
        ty = torch.from_numpy(ty).to(dev)[None, :, None, None]
        tx = torch.from_numpy(tx).to(dev)[None, None, :, None]
        rows0, rows1 = x[:, y0], x[:, y1]                    # (bs, uh, sw, c)
        top_ = rows0[:, :, x0] * (1 - tx) + rows0[:, :, x1] * tx
        bot_ = rows1[:, :, x0] * (1 - tx) + rows1[:, :, x1] * tx
        x = top_ * (1 - ty) + bot_ * ty
        x = torch.floor(x.clamp(0.0, 255.0) + 0.5)
    out = torch.full((bs, nh, nw, c), float(fill), dtype=torch.float32,
                     device=dev)
    out[:, top:top + uh, left:left + uw] = x
    return out / 255.0


def make_serving_fn(model, anchors_norm, src_hw: Tuple[int, int],
                    image_size: int = 640, conf: float = 0.25,
                    iou: float = 0.45, max_detections: int = 300,
                    pre_nms_topk: int = 1024, backend: str = "auto"):
    """End-to-end serving function: raw uint8 frames -> detections in
    original-image coordinates.

    Returns fn(images_u8 (bs, src_h, src_w, 3), on the model's device) ->
    (det (bs, max_det, 6), valid (bs, max_det)), det rows (class, conf, x1,
    y1, x2, y2) unletterboxed to the source frame."""
    from yolov5m_tpu_torch.ops.boxes import unletterbox_boxes
    from yolov5m_tpu_torch.ops.postprocess import fused_detect

    ratio, (dw, dh), _, _ = letterbox_geometry(src_hw,
                                               (image_size, image_size))

    @torch.no_grad()
    def serve(images_u8: torch.Tensor):
        x = letterbox_normalize(images_u8, (image_size, image_size))
        preds = model(x)
        det, valid = fused_detect(preds, anchors_norm, conf_threshold=conf,
                                  iou_threshold=iou,
                                  max_detections=max_detections,
                                  pre_nms_topk=pre_nms_topk, backend=backend)
        boxes = unletterbox_boxes(det[..., 2:6], ratio, (dw, dh), src_hw)
        return torch.cat([det[..., :2], boxes], -1), valid

    return serve
