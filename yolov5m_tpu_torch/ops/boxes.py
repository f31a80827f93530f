"""Box geometry: port of the serving path's part of ``yolov5m_tpu/ops/boxes.py``.

Plain tensor functions with arbitrary leading batch dimensions, in the
JAX package's operation order so that float32 results agree bit for bit
where the operations are the same.
"""

from __future__ import annotations

import numpy as np
import torch


def pairwise_iou_xyxy(boxes1: torch.Tensor, boxes2: torch.Tensor,
                      eps: float = 1e-7) -> torch.Tensor:
    """All-pairs IoU between corner-format box sets (..., N, 4) and
    (..., M, 4) -> (..., N, M). Order of operations as the JAX twin:
    ``area1 + area2 - inter + eps``, then the divide."""
    a = boxes1[..., :, None, :]
    b = boxes2[..., None, :, :]
    inter_w = (torch.minimum(a[..., 2], b[..., 2])
               - torch.maximum(a[..., 0], b[..., 0])).clamp(min=0)
    inter_h = (torch.minimum(a[..., 3], b[..., 3])
               - torch.maximum(a[..., 1], b[..., 1])).clamp(min=0)
    inter = inter_w * inter_h
    area1 = (boxes1[..., 2] - boxes1[..., 0]) * (boxes1[..., 3] - boxes1[..., 1])
    area2 = (boxes2[..., 2] - boxes2[..., 0]) * (boxes2[..., 3] - boxes2[..., 1])
    union = area1[..., :, None] + area2[..., None, :] - inter + eps
    return inter / union


def xywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """Midpoint (cx, cy, w, h) -> corners (x1, y1, x2, y2), same units."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def clip_boxes(boxes: torch.Tensor, shape_hw) -> torch.Tensor:
    """Clip xyxy boxes to image bounds (h, w)."""
    h, w = shape_hw
    x1, y1, x2, y2 = boxes[..., :4].unbind(-1)
    return torch.stack([x1.clamp(0, w), y1.clamp(0, h),
                        x2.clamp(0, w), y2.clamp(0, h)], -1)


def _ratio_xy(ratio):
    return (ratio, ratio) if not hasattr(ratio, "__len__") else ratio


def unletterbox_boxes(boxes: torch.Tensor, ratio, dwdh, orig_hw) -> torch.Tensor:
    """Map xyxy boxes (box in the first 4 columns) from letterbox space back
    onto the original image: remove the padding, undo the resize, clip."""
    rw, rh = _ratio_xy(ratio)
    dw, dh = dwdh
    h0, w0 = orig_hw
    return torch.stack([
        ((boxes[..., 0] - dw) / rw).clamp(0, w0),
        ((boxes[..., 1] - dh) / rh).clamp(0, h0),
        ((boxes[..., 2] - dw) / rw).clamp(0, w0),
        ((boxes[..., 3] - dh) / rh).clamp(0, h0),
    ], -1)


def unletterbox_boxes_np(boxes, ratio, dwdh, orig_hw) -> np.ndarray:
    """Host numpy twin of unletterbox_boxes, for per-request reply paths."""
    rw, rh = _ratio_xy(ratio)
    dw, dh = dwdh
    h0, w0 = orig_hw
    b = np.asarray(boxes, np.float32)
    x1 = np.clip((b[..., 0] - dw) / rw, 0, w0)
    y1 = np.clip((b[..., 1] - dh) / rh, 0, h0)
    x2 = np.clip((b[..., 2] - dw) / rw, 0, w0)
    y2 = np.clip((b[..., 3] - dh) / rh, 0, h0)
    return np.stack([x1, y1, x2, y2], axis=-1)
