"""COCO-style mean average precision, numpy only.

Own copy of ``yolov5m_tpu/eval/metrics.py`` (the port imports nothing of
the JAX package; the two must give the same dicts): 101-point interpolated
PR integration over IoU thresholds 0.50:0.95:0.05, greedy per-image
matching (the highest-confidence detection takes the best still-unmatched
GT with IoU >= t, COCOeval semantics), predictions accumulated per image,
ground truth from the raw labels.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)  # 0.50 … 0.95
RECALL_POINTS = np.linspace(0.0, 1.0, 101)

# COCOeval areaRng (pixels²). GT/detections outside a range are IGNORED for
# that range (not counted as FN/FP), per pycocotools semantics. Areas are
# box areas (w*h) — COCO proper uses segmentation area; for box-only eval
# torchmetrics does the same thing.
AREA_RANGES = (
    ("all", 0.0, 1e10),
    ("small", 0.0, 32.0 ** 2),
    ("medium", 32.0 ** 2, 96.0 ** 2),
    ("large", 96.0 ** 2, 1e10),
)


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) xyxy vs (M,4) xyxy → (N,M)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    ix = np.clip(np.minimum(a[:, None, 2], b[None, :, 2])
                 - np.maximum(a[:, None, 0], b[None, :, 0]), 0, None)
    iy = np.clip(np.minimum(a[:, None, 3], b[None, :, 3])
                 - np.maximum(a[:, None, 1], b[None, :, 1]), 0, None)
    inter = ix * iy
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-9)


class MeanAveragePrecision:
    """Streaming accumulator: update(preds, targets) per image, then compute().

    preds:   dict(boxes=(n,4) xyxy, scores=(n,), labels=(n,))
    targets: dict(boxes=(m,4) xyxy, labels=(m,))
    """

    def __init__(self, iou_thresholds: Optional[Sequence[float]] = None,
                 max_det: Optional[int] = None):
        """max_det: COCOeval's maxDets — keep only the top-k detections by
        score per (image, category), matching pycocotools evaluateImg's
        `dt = dt[0:maxDet]` under useCats=1 (COCO uses 100; torchmetrics'
        headline `map` likewise). Default None: the detection pipeline
        already caps at 300 per image via NMS (reference
        bboxes_utils.py:207)."""
        self.iou_thresholds = np.asarray(
            iou_thresholds if iou_thresholds is not None else IOU_THRESHOLDS)
        self.max_det = max_det
        # (scores, tp (nd,nt,nr), ig (nd,nt,nr), pred_cls)
        self._records: List[tuple] = []
        # non-ignored GT count per (class, range index)
        self._gt_counts: Dict[tuple, int] = {}

    def update(self, preds: dict, targets: dict,
               area_scale: float = 1.0) -> None:
        """area_scale: multiplier mapping box areas from the caller's
        coordinate space to ORIGINAL-image pixels² for the small/medium/large
        buckets — pass (w_orig/w_net)*(h_orig/h_net) when boxes are in
        resized network-input coordinates. COCOeval buckets areas in original
        image pixels (images are resized only AFTER area bucketing); without
        the scale, size-bucket APs are only self-consistent in network space.
        The 'all' range is unaffected."""
        boxes = np.asarray(preds["boxes"], np.float32).reshape(-1, 4)
        scores = np.asarray(preds["scores"], np.float32).reshape(-1)
        labels = np.asarray(preds["labels"]).reshape(-1).astype(int)
        gt_boxes = np.asarray(targets["boxes"], np.float32).reshape(-1, 4)
        gt_labels = np.asarray(targets["labels"]).reshape(-1).astype(int)

        gt_area = ((gt_boxes[:, 2] - gt_boxes[:, 0])
                   * (gt_boxes[:, 3] - gt_boxes[:, 1])) * float(area_scale)
        det_area = ((boxes[:, 2] - boxes[:, 0])
                    * (boxes[:, 3] - boxes[:, 1])) * float(area_scale)
        nr = len(AREA_RANGES)
        # per-range GT ignore: outside the area range (COCOeval _ignore)
        gt_ig = np.stack([(gt_area < lo) | (gt_area > hi)
                          for _, lo, hi in AREA_RANGES], axis=1)  # (m, nr)
        det_out = np.stack([(det_area < lo) | (det_area > hi)
                            for _, lo, hi in AREA_RANGES], axis=1)  # (n, nr)

        for gi, c in enumerate(gt_labels):
            for r in range(nr):
                if not gt_ig[gi, r]:
                    key = (int(c), r)
                    self._gt_counts[key] = self._gt_counts.get(key, 0) + 1

        if len(boxes) == 0:
            return

        order = np.argsort(-scores, kind="stable")
        boxes, scores, labels = boxes[order], scores[order], labels[order]
        det_out = det_out[order]
        if self.max_det is not None:
            # per (image, category), like COCOeval under useCats=1 — a
            # global top-k would let a dense class evict another class's
            # detections entirely
            keep = np.ones(len(labels), bool)
            for c in np.unique(labels):
                idx = np.nonzero(labels == c)[0]
                keep[idx[self.max_det:]] = False
            boxes, scores, labels = boxes[keep], scores[keep], labels[keep]
            det_out = det_out[keep]

        nt = len(self.iou_thresholds)
        thr = self.iou_thresholds[:, None]                  # (nt, 1)
        tp = np.zeros((len(boxes), nt, nr), bool)
        ig = np.zeros((len(boxes), nt, nr), bool)
        for c in np.unique(labels):
            det_idx = np.nonzero(labels == c)[0]
            gt_idx = np.nonzero(gt_labels == c)[0]
            if len(gt_idx) == 0:
                # unmatched detections outside the range are ignored, not FP
                ig[det_idx] = det_out[det_idx][:, None, :]
                continue
            iou = _iou_matrix(boxes[det_idx], gt_boxes[gt_idx])
            # greedy matching, all IoU thresholds AND area ranges in
            # lockstep: the detection loop is inherently sequential (GT
            # availability depends on earlier matches), but each (threshold,
            # range) cell matches independently — one (nr, nt, n_gt) mask
            # pass per detection. COCOeval rule per range: prefer the best
            # non-ignored candidate; fall back to the best ignored one (the
            # detection is then itself ignored); unmatched out-of-range
            # detections are ignored too.
            ng = len(gt_idx)
            g_ig = gt_ig[gt_idx].T[:, None, :]              # (nr, 1, ng)
            thr3 = self.iou_thresholds[None, :, None]       # (1, nt, 1)
            taken = np.zeros((nr, nt, ng), bool)
            for di in range(len(det_idx)):
                iou_row = iou[di][None, None, :]            # (1, 1, ng)
                cand = ~taken & (iou_row >= thr3)           # (nr, nt, ng)
                cand_ok = cand & ~g_ig
                has_ok = cand_ok.any(axis=-1)               # (nr, nt)
                best_ok = np.argmax(
                    np.where(cand_ok, iou_row, -1.0), axis=-1)
                cand_igm = cand & g_ig
                has_igm = cand_igm.any(axis=-1) & ~has_ok
                best_igm = np.argmax(
                    np.where(cand_igm, iou_row, -1.0), axis=-1)
                matched = has_ok | has_igm
                best = np.where(has_ok, best_ok, best_igm)
                ri, ti = np.nonzero(matched)
                taken[ri, ti, best[ri, ti]] = True
                tp[det_idx[di]] = has_ok.T                  # (nt, nr)
                ig[det_idx[di]] = (has_igm
                                   | (~matched
                                      & det_out[det_idx[di]][:, None])).T
        self._records.append((scores, tp, ig, labels))

    def compute(self) -> Dict[str, float]:
        if not self._records:
            # full key set either way (consumers index "precision" etc.),
            # with the SAME sentinel conventions as the populated path:
            # zero detections against EXISTING ground truth is a true 0.0
            # (early-epoch models; precision/recall 0.0 matches the
            # populated path's no-detections-for-class case), while -1.0
            # means "no data for this statistic" (torchmetrics' undefined
            # sentinel, which the reference's eval surfaces —
            # validation_utils.py:128). Per-area keys check THEIR OWN
            # range's GT so an all-small dataset reads map_large = -1.0
            # here exactly as it would one epoch later.
            v = 0.0 if self._gt_counts else -1.0
            out = {"map": v, "map_50": v, "map_75": v,
                   "precision": v, "recall": v, "ap_per_class": {}}
            for r, (name, _, _) in enumerate(AREA_RANGES):
                if name != "all":
                    has_gt = any(k[1] == r and n > 0
                                 for k, n in self._gt_counts.items())
                    out[f"map_{name}"] = 0.0 if has_gt else -1.0
            return out
        scores = np.concatenate([r[0] for r in self._records])
        tp = np.concatenate([r[1] for r in self._records])    # (nd, nt, nr)
        ig = np.concatenate([r[2] for r in self._records])
        labels = np.concatenate([r[3] for r in self._records])

        order = np.argsort(-scores, kind="stable")
        tp, ig, labels = tp[order], ig[order], labels[order]

        classes = sorted({c for (c, r) in self._gt_counts})
        nt = len(self.iou_thresholds)
        nr = len(AREA_RANGES)
        ap = np.full((nr, len(classes), nt), np.nan)

        t50_ = int(np.argmin(np.abs(self.iou_thresholds - 0.5)))
        pr_f1 = np.full((len(classes), 2), np.nan)   # per-class P, R @ max F1
        for ci, c in enumerate(classes):
            sel = labels == c
            for r in range(nr):
                n_gt = self._gt_counts.get((c, r), 0)
                if n_gt == 0:
                    continue                                 # nan: no GT here
                if not sel.any():
                    ap[r, ci] = 0.0
                    if r == 0:
                        pr_f1[ci] = (0.0, 0.0)
                    continue
                tpc = tp[sel, :, r].astype(np.float64)       # (nd, nt)
                igc = ig[sel, :, r]
                # ignored detections contribute to neither TP nor FP
                cum_tp = np.cumsum(np.where(igc, 0.0, tpc), axis=0)
                cum_fp = np.cumsum(np.where(igc | tpc.astype(bool), 0.0, 1.0),
                                   axis=0)
                recall = cum_tp / n_gt
                precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-9)
                if r == 0:
                    # P/R at the max-F1 operating point, IoU 0.5 ("all"
                    # range) — the Ultralytics val-table statistics
                    p50 = precision[:, t50_]
                    r50 = recall[:, t50_]
                    f1 = 2 * p50 * r50 / np.maximum(p50 + r50, 1e-9)
                    bi = int(np.argmax(f1))
                    pr_f1[ci] = (p50[bi], r50[bi])
                for ti in range(nt):
                    # monotone precision envelope + 101-pt integration
                    p = precision[:, ti]
                    rr = recall[:, ti]
                    p_env = np.maximum.accumulate(p[::-1])[::-1]
                    interp = np.zeros_like(RECALL_POINTS)
                    idx = np.searchsorted(rr, RECALL_POINTS, side="left")
                    valid = idx < len(p_env)
                    interp[valid] = p_env[idx[valid]]
                    ap[r, ci, ti] = interp.mean()

        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", category=RuntimeWarning)
            mean_ap = np.nanmean(ap, axis=1)                 # (nr, nt)
        t50 = int(np.argmin(np.abs(self.iou_thresholds - 0.5)))
        t75 = int(np.argmin(np.abs(self.iou_thresholds - 0.75)))
        with np.errstate(invalid="ignore"):
            import warnings as _w
            with _w.catch_warnings():
                _w.simplefilter("ignore", category=RuntimeWarning)
                mp, mr = np.nanmean(pr_f1, axis=0)
        out = {
            "map": float(np.nanmean(mean_ap[0])),
            "map_50": float(mean_ap[0, t50]),
            "map_75": float(mean_ap[0, t75]),
            # macro-averaged P/R at each class's max-F1 point, IoU 0.5
            # (Ultralytics val-table semantics)
            "precision": float(mp) if not np.isnan(mp) else -1.0,
            "recall": float(mr) if not np.isnan(mr) else -1.0,
            "ap_per_class": {int(c): float(np.nanmean(ap[0, ci]))
                             for ci, c in enumerate(classes)},
        }
        for r, (name, _, _) in enumerate(AREA_RANGES):
            if name != "all":
                out[f"map_{name}"] = float(np.nanmean(mean_ap[r])) \
                    if not np.all(np.isnan(mean_ap[r])) else -1.0
        return out

    def reset(self) -> None:
        self._records.clear()
        self._gt_counts.clear()
