"""Detection confusion matrix, per-class error analysis, numpy only.

Own copy of ``yolov5m_tpu/eval/confusion.py``. Ultralytics-style: an
(nc+1, nc+1) matrix over predicted class (rows) vs true class (columns),
with the extra index for background — unmatched GT land in
[background, true_cls] (missed), unmatched detections in
[pred_cls, background] (false alarms). Matching is per image: detections
above conf_threshold, greedy best-IoU pairing at iou_threshold, class-blind
(so cross-class confusions are visible — that is the point of the matrix).
"""

from __future__ import annotations

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
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


class ConfusionMatrix:
    def __init__(self, nc: int, conf_threshold: float = 0.25,
                 iou_threshold: float = 0.45):
        self.nc = nc
        self.conf_threshold = conf_threshold
        self.iou_threshold = iou_threshold
        self.matrix = np.zeros((nc + 1, nc + 1), np.int64)

    @property
    def background(self) -> int:
        return self.nc

    def update(self, preds: dict, targets: dict) -> None:
        boxes = np.asarray(preds["boxes"], np.float32).reshape(-1, 4)
        scores = np.asarray(preds["scores"], np.float32).reshape(-1)
        labels = np.asarray(preds["labels"]).reshape(-1).astype(int)
        keep = scores >= self.conf_threshold
        boxes, labels = boxes[keep], labels[keep]
        gt_boxes = np.asarray(targets["boxes"], np.float32).reshape(-1, 4)
        gt_labels = np.asarray(targets["labels"]).reshape(-1).astype(int)

        iou = _iou_matrix(boxes, gt_boxes)
        det_matched = np.zeros(len(boxes), bool)
        gt_matched = np.zeros(len(gt_boxes), bool)
        # greedy by IoU over all candidate pairs above threshold
        if iou.size:
            cand = np.argwhere(iou >= self.iou_threshold)
            order = np.argsort(-iou[cand[:, 0], cand[:, 1]])
            for d, g in cand[order]:
                if det_matched[d] or gt_matched[g]:
                    continue
                det_matched[d] = gt_matched[g] = True
                self.matrix[labels[d], gt_labels[g]] += 1
        for d in np.nonzero(~det_matched)[0]:
            self.matrix[labels[d], self.background] += 1
        for g in np.nonzero(~gt_matched)[0]:
            self.matrix[self.background, gt_labels[g]] += 1

    def per_class(self) -> dict:
        """{'tp', 'fp', 'fn'} arrays of length nc (diagonal vs off)."""
        m = self.matrix
        tp = np.diag(m)[: self.nc]
        fp = m[: self.nc].sum(axis=1) - tp          # predicted c, wrong
        fn = m[:, : self.nc].sum(axis=0) - tp       # true c, missed/confused
        return {"tp": tp, "fp": fp, "fn": fn}

    def save_csv(self, path: str, class_names=None) -> None:
        names = list(class_names or range(self.nc))
        # defensive length normalization: a short custom label list would
        # IndexError mid-write (leaving a truncated CSV on disk) and a
        # long one would silently shift every header column
        names = ([str(n) for n in names[: self.nc]]
                 + [str(i) for i in range(len(names), self.nc)])
        names += ["background"]
        with open(path, "w") as f:
            f.write("pred\\true," + ",".join(str(n) for n in names) + "\n")
            for i, row in enumerate(self.matrix):
                f.write(str(names[i]) + "," +
                        ",".join(str(int(v)) for v in row) + "\n")
