"""Anchor auto-tuning from dataset label statistics.

The reference trains with fixed COCO anchors (reference config.py:33-37) for
every dataset; real YOLOv5 recipes re-fit anchors to the target dataset
(Ultralytics autoanchor) — this module provides that: k-means over the
dataset's box shapes with the anchor-ratio fitness the loss actually uses
(anchor_t gating, train/targets.py), plus the best-possible-recall (BPR)
check that decides whether refitting is worth it.

Pure numpy, host-side, one-shot at train start (`--autoanchor`). An own
copy of ``yolov5m_tpu/data/autoanchor.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def collect_wh(dataset, image_size: int = 640,
               max_items: Optional[int] = 10000) -> np.ndarray:
    """(n, 2) label widths/heights in pixels at image_size, from a
    DetectionDataset (normalized labels * image_size)."""
    whs = []
    n = len(dataset) if max_items is None else min(len(dataset), max_items)
    load = getattr(dataset, "load_labels", None)
    for i in range(n):
        # labels-only path: no image decode (labels are normalized, so
        # anchor statistics never need pixels)
        labels = load(i) if load is not None else dataset.load_item(i)[1]
        if len(labels):
            whs.append(np.asarray(labels)[:, 3:5] * image_size)
    if not whs:
        raise ValueError("no labels found for anchor fitting")
    wh = np.concatenate(whs)
    return wh[(wh > 2.0).all(axis=1)]       # drop degenerate tiny boxes


def anchor_ratio_metric(wh: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """(n,) best-anchor ratio r = min_a max(w/aw, aw/w, h/ah, ah/h) — the
    quantity the ultralytics loss gates on (anchor_t, targets.py)."""
    r = wh[:, None, :] / anchors[None, :, :]             # (n, k, 2)
    worst = np.maximum(r, 1.0 / r).max(axis=2)           # (n, k)
    return worst.min(axis=1)


def best_possible_recall(wh: np.ndarray, anchors: np.ndarray,
                         anchor_t: float = 4.0) -> float:
    """Fraction of boxes that pass the anchor-ratio gate for SOME anchor —
    an upper bound on recall under the matching rule."""
    return float((anchor_ratio_metric(wh, anchors) < anchor_t).mean())


def fit_anchors(wh: np.ndarray, n_anchors: int = 9, iters: int = 50,
                seed: int = 0) -> np.ndarray:
    """k-means in log-wh space (Lloyd's; log space makes the euclidean
    metric scale-relative, matching the ratio gate's geometry). Returns
    (n_anchors, 2) pixel anchors sorted by area ascending."""
    rng = np.random.default_rng(seed)
    x = np.log(wh)
    # init: area quantiles with aspect jitter — deterministic and spread
    order = np.argsort(wh.prod(axis=1))
    qs = np.linspace(0, len(wh) - 1, n_anchors).astype(int)
    centers = x[order[qs]] + rng.normal(0, 0.01, (n_anchors, 2))
    for _ in range(iters):
        d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)   # (n, k)
        assign = d.argmin(axis=1)
        for k in range(n_anchors):
            sel = assign == k
            if sel.any():
                centers[k] = x[sel].mean(axis=0)
    anchors = np.exp(centers)
    return anchors[np.argsort(anchors.prod(axis=1))]


def check_and_fit(dataset, default_anchors, image_size: int = 640,
                  anchor_t: float = 4.0, bpr_threshold: float = 0.98
                  ) -> Tuple[np.ndarray, dict]:
    """Ultralytics check_anchors semantics: keep the defaults when their BPR
    is already >= bpr_threshold; otherwise k-means-refit and keep whichever
    anchor set scores the higher BPR.

    default_anchors: (nl, na, 2) pixels. Returns ((nl, na, 2), info dict).
    """
    default = np.asarray(default_anchors, np.float32)
    nl, na, _ = default.shape
    wh = collect_wh(dataset, image_size)
    flat = default.reshape(-1, 2)
    bpr0 = best_possible_recall(wh, flat, anchor_t)
    info = {"bpr_default": bpr0, "n_boxes": int(len(wh)), "refit": False}
    if bpr0 >= bpr_threshold:
        return default, info
    fitted = fit_anchors(wh, n_anchors=nl * na).astype(np.float32)
    bpr1 = best_possible_recall(wh, fitted, anchor_t)
    info["bpr_fitted"] = bpr1
    if bpr1 <= bpr0:
        return default, info
    info["refit"] = True
    return fitted.reshape(nl, na, 2), info
