"""CSV metrics logging: own copy of ``yolov5m_tpu/utils/logging.py``, with
the same schemas and resume behaviour.

loss.csv: epoch,batch_idx,box_loss,object_loss,class_loss, appended every
100 batches.
eval.csv: epoch,class_accuracy,obj_accuracy,map50,map75, appended per epoch.
"""

from __future__ import annotations

import csv
import os
from typing import Sequence

LOSS_HEADER = ("epoch", "batch_idx", "box_loss", "object_loss", "class_loss")
EVAL_HEADER = ("epoch", "class_accuracy", "obj_accuracy", "map50", "map75")


class CSVLogger:
    def __init__(self, root: str, filename: str, resume: bool = False):
        self.dir = os.path.join(root, filename)
        os.makedirs(self.dir, exist_ok=True)
        self.loss_path = os.path.join(self.dir, "loss.csv")
        self.eval_path = os.path.join(self.dir, "eval.csv")
        # resume appends to EXISTING logs; a missing file still gets its
        # header (e.g. the first run used --nosavelogs, the resume doesn't
        # — appending headerless data rows would silently shift every
        # column for any reader that treats row 0 as the header)
        for path, header in ((self.loss_path, LOSS_HEADER),
                             (self.eval_path, EVAL_HEADER)):
            if not resume or not os.path.isfile(path):
                self._write_header(path, header)

    @staticmethod
    def _write_header(path: str, header: Sequence[str]) -> None:
        with open(path, "w", newline="") as f:
            csv.writer(f).writerow(header)

    def _append(self, path: str, row: Sequence) -> None:
        with open(path, "a", newline="") as f:
            csv.writer(f).writerow(row)

    def log_loss(self, epoch: int, batch_idx: int, box: float, obj: float,
                 cls: float) -> None:
        self._append(self.loss_path, [epoch, batch_idx, box, obj, cls])

    def log_eval(self, epoch: int, class_acc: float, obj_acc: float,
                 map50: float, map75: float) -> None:
        self._append(self.eval_path,
                     [epoch, round(class_acc, 3), round(obj_acc, 3),
                      map50, map75])
