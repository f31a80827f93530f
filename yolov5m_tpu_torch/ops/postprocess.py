"""Fused detection postprocess: port of ``yolov5m_tpu/ops/postprocess.py``.

gate -> top-K -> gather -> decode -> NMS -> compact. Top-K candidates are
chosen on the raw objectness LOGIT (sigmoid is monotone), so only K rows
per image are gathered and decoded instead of all N = sum(na*ny*nx).
Candidates are ordered by logit; ties keep index order, as lax.top_k does.

Two gates pick the K candidates: "sort" (a stable sort of all N gated
logits; what "auto" resolves to, as in JAX) and "compact" (a prefix sum
over the gate mask, a binary search for each of the first K survivors,
then a stable sort of those K rows). Below capacity, at most K survivors
an image, the two give the same detections; above it, compact keeps the K
lowest-index survivors. ``gate_density`` counts an image's survivors and
detections.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from yolov5m_tpu_torch.ops.decode import make_grid
from yolov5m_tpu_torch.ops.nms import (
    NEG_INF, _compact, resolve_backend, suppress)


def _row_tables(grid_sizes: Sequence[Tuple[int, int]], anchors_norm,
                strides: Sequence[int], device=None):
    """Per-row (flat index) decode tables: grid xy (N, 2), anchor wh in
    pixels (N, 2), stride (N,). Layout matches decode_layer's reshape
    (anchor-major, then y, x)."""
    anchors_norm = torch.as_tensor(anchors_norm, dtype=torch.float32,
                                   device=device)
    na = anchors_norm.shape[1]
    gxy, awh, std = [], [], []
    for s, (ny, nx) in enumerate(grid_sizes):
        g = make_grid(ny, nx, device=device).reshape(1, ny * nx, 2)
        gxy.append(g.expand(na, ny * nx, 2).reshape(-1, 2))
        a = (anchors_norm[s] * strides[s])[:, None, :]
        awh.append(a.expand(na, ny * nx, 2).reshape(-1, 2))
        std.append(torch.full((na * ny * nx,), float(strides[s]),
                              dtype=torch.float32, device=device))
    return torch.cat(gxy), torch.cat(awh), torch.cat(std)


def _gate_topk_sort(gated: torch.Tensor, k: int):
    """Exact top-k by a full stable sort: equal scores keep index order,
    which the NEG_INF rows and saturated logits rely on (torch.topk makes
    no such promise)."""
    top_logits, top_idx = torch.sort(gated, dim=1, descending=True,
                                      stable=True)
    top_logits, top_idx = top_logits[:, :k], top_idx[:, :k]
    return top_logits, top_idx, top_logits > NEG_INF / 2


def _gate_compact(gated: torch.Tensor, k: int):
    """The K candidates by compaction: the j-th survivor of the gate is
    the first row whose prefix count of survivors reaches j + 1 (a binary
    search in the prefix sum), then only those K rows are sorted by
    logit, stably. Below capacity (at most K survivors) the valid rows and
    their order are those of _gate_topk_sort; rows past the last survivor
    point at row N-1 with a NEG_INF logit and are invalid. Above capacity
    the K lowest-index survivors are kept, not the K highest-scoring."""
    bs, n = gated.shape
    k = min(k, n)
    csum = torch.cumsum((gated > NEG_INF / 2).int(), dim=1, dtype=torch.int32)
    want = torch.arange(1, k + 1, dtype=torch.int32,
                        device=gated.device).expand(bs, k).contiguous()
    idx = torch.searchsorted(csum, want, side="left")
    in_range = idx < n
    idx = torch.where(in_range, idx, torch.full_like(idx, n - 1))
    logits = torch.where(in_range, gated.gather(1, idx),
                         torch.full_like(idx, NEG_INF, dtype=gated.dtype))
    top_logits, perm = torch.sort(logits, dim=1, descending=True, stable=True)
    return top_logits, idx.gather(1, perm), top_logits > NEG_INF / 2


GATES = ("auto", "sort", "compact")


def candidates(preds: Sequence[torch.Tensor], anchors_norm,
               strides: Tuple[int, ...] = (8, 16, 32),
               conf_threshold: float = 0.25, pre_nms_topk: int = 1024,
               gate: str = "auto"):
    """Gate, top-K and decode: the NMS input of fused_detect.

    gate: "sort", "compact" or "auto" (sort). Returns (boxes (bs, K, 4)
    xyxy f32, cls (bs, K) f32, conf (bs, K) f32, valid (bs, K) bool), in
    descending-logit order, K = min(pre_nms_topk, N).
    """
    # an unknown gate raises: a typo quietly taking the default would
    # corrupt an A/B measurement
    if gate not in GATES:
        raise ValueError(f"gate must be auto|sort|compact, got {gate!r}")
    device = preds[0].device
    grid_sizes = [(p.shape[2], p.shape[3]) for p in preds]
    gxy, awh, std = _row_tables(grid_sizes, anchors_norm, strides, device)

    bs, no = preds[0].shape[0], preds[0].shape[-1]
    flat = torch.cat([p.reshape(bs, -1, no) for p in preds], 1)  # (bs, N, no)
    obj_logit = flat[..., 4].float()                              # (bs, N)

    k = min(pre_nms_topk, flat.shape[1])
    # gate on logits in f32; the threshold is worked out in Python float
    logit_thresh = math.log(conf_threshold / (1.0 - conf_threshold))
    gated = torch.where(obj_logit > logit_thresh, obj_logit,
                        torch.full_like(obj_logit, NEG_INF))
    gate_fn = _gate_compact if gate == "compact" else _gate_topk_sort
    top_logits, top_idx, valid = gate_fn(gated, k)                # (bs, K)

    rows = flat.gather(1, top_idx[..., None].expand(-1, -1, no)).float()
    g, a, s = gxy[top_idx], awh[top_idx], std[top_idx][..., None]

    xy = (2.0 * torch.sigmoid(rows[..., 0:2]) + g - 0.5) * s
    wh = (2.0 * torch.sigmoid(rows[..., 2:4])) ** 2 * a
    conf = torch.sigmoid(top_logits)
    cls = rows[..., 5:].argmax(-1).float()       # first maximum on ties
    boxes = torch.cat([xy - wh / 2, xy + wh / 2], -1)             # (bs, K, 4)
    return boxes, cls, conf, valid


def fused_detect(preds: Sequence[torch.Tensor], anchors_norm,
                 strides: Tuple[int, ...] = (8, 16, 32),
                 conf_threshold: float = 0.25, iou_threshold: float = 0.45,
                 max_detections: int = 300, pre_nms_topk: int = 1024,
                 backend: str = "auto", gate: str = "auto"):
    """preds: list of (bs, na, ny, nx, 5+nc) raw logits (any float dtype).
    gate: how the K candidates are picked ("auto" = "sort", or "compact").

    Returns (out (bs, max_det, 6) [class, conf, x1, y1, x2, y2] f32,
    valid (bs, max_det) bool)."""
    boxes, cls, conf, valid = candidates(preds, anchors_norm, strides,
                                         conf_threshold, pre_nms_topk, gate)
    backend = resolve_backend(backend, boxes.device)
    keep = suppress(boxes, cls, valid, iou_threshold, backend=backend)
    return _compact(boxes, cls, conf, keep, max_detections)


def gate_density(preds: Sequence[torch.Tensor], anchors_norm,
                 conf_threshold: float = 0.25, iou_threshold: float = 0.45,
                 max_detections: int = 300, pre_nms_topk: int = 1024,
                 backend: str = "auto",
                 strides: Tuple[int, ...] = (8, 16, 32)):
    """The postprocess's work an image: (gate survivors, detections), each
    (bs,) int64. A survivor is a grid cell whose objectness logit clears
    the confidence gate, sigma(obj) > conf: the candidates top-K and NMS
    see. The detections are fused_detect's valid rows (the sort gate)."""
    thresh = math.log(conf_threshold / (1.0 - conf_threshold))
    obj = torch.cat([p[..., 4].reshape(p.shape[0], -1) for p in preds], 1)
    survivors = (obj.float() > thresh).sum(1)
    _, valid = fused_detect(preds, anchors_norm, strides=strides,
                            conf_threshold=conf_threshold,
                            iou_threshold=iou_threshold,
                            max_detections=max_detections,
                            pre_nms_topk=pre_nms_topk, backend=backend)
    return survivors, valid.sum(1)
