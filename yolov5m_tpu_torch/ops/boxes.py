"""Box geometry: port of ``yolov5m_tpu/ops/boxes.py``.

Plain tensor functions with arbitrary leading batch dimensions, in the
JAX package's operation order so that float32 results agree bit for bit
where the operations are the same.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def iou_wh(wh1: torch.Tensor, wh2: torch.Tensor) -> torch.Tensor:
    """IoU from widths and heights only (co-centred boxes), for anchor
    matching. wh1, wh2: (..., 2), broadcastable. Returns (...,)."""
    inter = (torch.minimum(wh1[..., 0], wh2[..., 0])
             * torch.minimum(wh1[..., 1], wh2[..., 1]))
    union = wh1[..., 0] * wh1[..., 1] + wh2[..., 0] * wh2[..., 1] - inter
    return inter / union


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
            box_format: str = "midpoint", giou: bool = False,
            diou: bool = False, ciou: bool = False,
            eps: float = 1e-7) -> torch.Tensor:
    """IoU variants between paired boxes (..., 4), midpoint (cx, cy, w, h)
    or corners (x1, y1, x2, y2); at most one of giou/diou/ciou, none for
    plain IoU. Returns (..., 1). CIoU's alpha carries no gradient."""
    if box_format == "midpoint":
        b1_x1 = boxes1[..., 0:1] - boxes1[..., 2:3] / 2
        b1_y1 = boxes1[..., 1:2] - boxes1[..., 3:4] / 2
        b1_x2 = boxes1[..., 0:1] + boxes1[..., 2:3] / 2
        b1_y2 = boxes1[..., 1:2] + boxes1[..., 3:4] / 2
        b2_x1 = boxes2[..., 0:1] - boxes2[..., 2:3] / 2
        b2_y1 = boxes2[..., 1:2] - boxes2[..., 3:4] / 2
        b2_x2 = boxes2[..., 0:1] + boxes2[..., 2:3] / 2
        b2_y2 = boxes2[..., 1:2] + boxes2[..., 3:4] / 2
    else:
        b1_x1, b1_y1, b1_x2, b1_y2 = (boxes1[..., i:i + 1] for i in range(4))
        b2_x1, b2_y1, b2_x2, b2_y2 = (boxes2[..., i:i + 1] for i in range(4))

    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1
    inter_w = (torch.minimum(b1_x2, b2_x2)
               - torch.maximum(b1_x1, b2_x1)).clamp(min=0)
    inter_h = (torch.minimum(b1_y2, b2_y2)
               - torch.maximum(b1_y1, b2_y1)).clamp(min=0)
    inter = inter_w * inter_h
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union

    if giou or diou or ciou:
        cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
        ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
        if giou:
            c_area = cw * ch + eps
            return iou - (c_area - union) / c_area
        c2 = cw ** 2 + ch ** 2 + eps
        rho2 = ((b1_x1 + b1_x2 - b2_x1 - b2_x2) ** 2
                + (b1_y1 + b1_y2 - b2_y1 - b2_y2) ** 2) / 4.0
        if diou:
            return iou - rho2 / c2
        v = (4 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps))
                                  - torch.atan(w1 / (h1 + eps))) ** 2
        alpha = (v / (v - iou + (1 + eps))).detach()
        return iou - (rho2 / c2 + v * alpha)
    return iou


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


def coco_to_yolo(boxes: torch.Tensor, w0: float = 640.0,
                 h0: float = 640.0) -> torch.Tensor:
    """COCO (x1, y1, w, h) absolute -> YOLO (cx, cy, w, h) normalized."""
    x1, y1, w, h = boxes[..., :4].unbind(-1)
    return torch.stack([(2 * x1 + w) / (2 * w0), (2 * y1 + h) / (2 * h0),
                        w / w0, h / h0], -1)


def xywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """Midpoint (cx, cy, w, h) -> corners (x1, y1, x2, y2), same units."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    """Corners (x1, y1, x2, y2) -> midpoint (cx, cy, w, h), same units."""
    x1, y1, x2, y2 = boxes[..., :4].unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def xywhn_to_xyxy(boxes: torch.Tensor, w: float = 640, h: float = 640,
                  padw: float = 0, padh: float = 0) -> torch.Tensor:
    """Normalized midpoint -> absolute corners, plus an optional pad."""
    cx, cy, bw, bh = boxes[..., :4].unbind(-1)
    return torch.stack([w * (cx - bw / 2) + padw, h * (cy - bh / 2) + padh,
                        w * (cx + bw / 2) + padw, h * (cy + bh / 2) + padh],
                       -1)


def xywhn_to_xyxy_np(boxes, w: float = 640, h: float = 640) -> np.ndarray:
    """Host numpy twin of xywhn_to_xyxy, for the evaluator's matcher."""
    cx, cy, bw, bh = (boxes[..., i] for i in range(4))
    return np.stack([w * (cx - bw / 2), h * (cy - bh / 2),
                     w * (cx + bw / 2), h * (cy + bh / 2)], axis=-1)


def xyxy_to_xywhn(boxes: torch.Tensor, w: float = 640,
                  h: float = 640) -> torch.Tensor:
    """Absolute corners -> normalized midpoint."""
    x1, y1, x2, y2 = boxes[..., :4].unbind(-1)
    return torch.stack([((x1 + x2) / 2) / w, ((y1 + y2) / 2) / h,
                        (x2 - x1) / w, (y2 - y1) / h], -1)


def rescale_boxes(boxes: torch.Tensor, starting_size,
                  ending_size) -> torch.Tensor:
    """Rescale the first 4 columns between image sizes (w, h), truncated to
    2 decimals as the reference does: floor(x * scale * 100) / 100."""
    sw, sh = starting_size
    ew, eh = ending_size
    scale = torch.tensor([ew / sw, eh / sh, ew / sw, eh / sh],
                         dtype=boxes.dtype, device=boxes.device)
    return torch.floor(boxes[..., :4] * scale * 100) / 100


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
