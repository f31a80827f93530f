"""Standard COCO-format eval dumps for external validation.

Writes the two files the official COCO tooling consumes:

  * ``annotations.json`` — GT in COCO object-detection format
    (images / annotations / categories);
  * ``results.json``     — detections in COCO results format
    ([{image_id, category_id, bbox [x,y,w,h], score}]).

Own copy of ``yolov5m_tpu/eval/coco_dump.py``: the dumps let anyone score
the same predictions with pycocotools or torchmetrics, so the port's own
mAP (eval/metrics.py) can be checked externally.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence


class CocoDump:
    """Accumulates per-image detections + GT; writes COCO-format JSONs."""

    def __init__(self, class_names: Optional[Sequence[str]] = None):
        self.class_names = class_names
        self.images = []
        self.annotations = []
        self.results = []
        self._next_ann_id = 1
        self._cat_ids = set()

    def add_image(self, image_id: int, width: int, height: int,
                  pred_boxes_xyxy, pred_scores, pred_labels,
                  gt_boxes_xyxy, gt_labels) -> None:
        self.images.append({"id": int(image_id), "width": int(width),
                            "height": int(height)})
        for box, score, label in zip(pred_boxes_xyxy, pred_scores,
                                     pred_labels):
            x1, y1, x2, y2 = (float(v) for v in box)
            self.results.append({
                "image_id": int(image_id),
                "category_id": int(label),
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "score": float(score),
            })
            self._cat_ids.add(int(label))
        for box, label in zip(gt_boxes_xyxy, gt_labels):
            x1, y1, x2, y2 = (float(v) for v in box)
            w, h = x2 - x1, y2 - y1
            self.annotations.append({
                "id": self._next_ann_id,
                "image_id": int(image_id),
                "category_id": int(label),
                "bbox": [x1, y1, w, h],
                "area": w * h,
                "iscrowd": 0,
            })
            self._next_ann_id += 1
            self._cat_ids.add(int(label))

    def write(self, out_dir: str) -> dict:
        os.makedirs(out_dir, exist_ok=True)
        cats = []
        for c in sorted(self._cat_ids):
            name = (self.class_names[c]
                    if self.class_names and c < len(self.class_names)
                    else str(c))
            cats.append({"id": int(c), "name": name})
        ann_path = os.path.join(out_dir, "annotations.json")
        res_path = os.path.join(out_dir, "results.json")
        with open(ann_path, "w") as f:
            json.dump({"images": self.images,
                       "annotations": self.annotations,
                       "categories": cats}, f)
        with open(res_path, "w") as f:
            json.dump(self.results, f)
        return {"annotations": ann_path, "results": res_path}
