"""Validation: class and objectness accuracy, mAP50/75, through the fused
detection path and the CUDA NMS kernel.

Port of ``yolov5m_tpu/eval/evaluator.py``:

  * BatchNorm is folded into the convs once per ``run`` (models/fuse.py)
    and the BN-free twin of the model runs the batches;
  * detections come from ``fused_detect`` at the eval gate (conf 0.01,
    iou 0.6, K 1024 candidates): on CUDA tensors its NMS is the
    hand-written kernel, one launch per batch;
  * objectness accuracy reads channel 4 (sigmoid > conf_threshold) and
    class accuracy is counted at the positive cells of
    ``build_grid_targets``;
  * the greedy mAP matcher runs on the host per image, skipping rows with
    ``image_valid`` false, with areas bucketed in ``orig_hw`` pixels;
  * depth-1 overlap: batch i+1's forward and detection are queued on the
    card before the host matches batch i. Each batch's results are copied
    into pinned host memory behind an event right after its own work, so
    waiting for batch i does not wait for batch i+1.

The result dict has the JAX package's keys. ``timing`` holds the last
run's wall seconds, images and host-matcher seconds.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from yolov5m_tpu_torch.config import STRIDES, Config
from yolov5m_tpu_torch.data.loaders import to_device
from yolov5m_tpu_torch.eval.metrics import MeanAveragePrecision
from yolov5m_tpu_torch.models.fuse import fold_batchnorm
from yolov5m_tpu_torch.models.yolo import YOLOv5
from yolov5m_tpu_torch.ops.boxes import xywhn_to_xyxy_np
from yolov5m_tpu_torch.ops.postprocess import fused_detect
from yolov5m_tpu_torch.train.targets import build_grid_targets


def _to_host(tensors, device):
    """(host tensors, event): a copy of each tensor in pinned host memory
    queued behind the work so far, and the event that marks it done; on
    the CPU, the tensors themselves and no event."""
    if device.type != "cuda":
        return tensors, None
    host = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    event = torch.cuda.Event()
    event.record()
    return host, event


class Evaluator:
    """Runs accuracy and mAP over a loader for given weights.

    model: the training model (``YOLOv5(fused=False)``), whose BN-folded
    twin runs the batches. anchors_norm: (nl, na, 2) anchors over their
    stride. nms_backend: the dispatch argument of ``fused_detect``; "auto"
    runs the CUDA kernel on the card ("torch" runs the plain version, for
    checking the kernel)."""

    def __init__(self, model: YOLOv5, anchors_norm, cfg: Config,
                 anchors_px: Optional[np.ndarray] = None,
                 overlap: bool = True, nms_backend: str = "auto"):
        if model.fused:
            raise ValueError("the Evaluator takes the model with BatchNorm "
                             "(fused=False) and folds it itself")
        self.model = model
        self.cfg = cfg
        self.overlap = overlap
        self.nms_backend = nms_backend
        self.anchors_norm = np.asarray(anchors_norm, np.float32)
        self.anchors_px = (np.asarray(anchors_px, np.float32)
                           if anchors_px is not None else
                           self.anchors_norm * np.asarray(
                               STRIDES, np.float32)[:, None, None])
        self._fused = None
        self.timing: Dict[str, float] = {}

    def fused_model(self, state_dict) -> YOLOv5:
        """The BN-free twin of the model, loaded with ``state_dict`` folded."""
        m = self.model
        if self._fused is None:
            w = m.backbone[0].cbl[0].weight
            self._fused = YOLOv5(m.first_out, m.nc, m.depth_mult, fused=True,
                                 compute_dtype=m.compute_dtype).to(
                device=w.device, dtype=w.dtype)
            if w.is_cuda:
                self._fused.to(memory_format=torch.channels_last)
        self._fused.load_state_dict(fold_batchnorm(state_dict), strict=True)
        return self._fused.eval()

    @torch.no_grad()
    def _start(self, model, batch, anchors_norm, anchors_px):
        """Queue one batch's device work; returns (batch, host results,
        event)."""
        cfg = self.cfg
        dev = anchors_px.device
        image, labels, mask = (to_device(batch[k], dev)
                               for k in ("image", "labels", "mask"))
        preds = model(image)
        det, det_valid = fused_detect(
            preds, anchors_norm, STRIDES, conf_threshold=cfg.conf_threshold,
            iou_threshold=cfg.nms_iou_thresh,
            max_detections=cfg.max_detections,
            pre_nms_topk=cfg.pre_nms_topk, backend=self.nms_backend)

        grid_sizes = [(p.shape[2], p.shape[3]) for p in preds]
        targets = build_grid_targets(labels, mask, anchors_px, grid_sizes,
                                     cfg.ignore_iou_thresh)
        counts = []
        for p, t in zip(preds, targets):
            pos = t[..., 4] == 1.0
            pred_cls = p[..., 5:].argmax(-1)
            obj_pred = torch.sigmoid(p[..., 4]) > cfg.conf_threshold
            counts += [(pos & (pred_cls == t[..., 5])).sum(), pos.sum(),
                       (pos & obj_pred).sum(), pos.sum()]
        c = torch.stack(counts).view(-1, 4).sum(0)
        host, event = _to_host([det, det_valid, c], dev)
        return batch, host, event

    def run(self, state_dict: Dict[str, torch.Tensor],
            loader: Iterable[dict], coco_dump_dir: Optional[str] = None,
            class_names=None, confusion_csv: Optional[str] = None) -> dict:
        """Evaluate ``state_dict`` (the model's keys, BatchNorm folded
        here) over a loader of {"image", "labels", "mask"} batches,
        optionally with "image_valid" and "orig_hw". coco_dump_dir: also
        write COCO-format annotations.json and results.json there;
        confusion_csv: also write a per-class confusion matrix."""
        dump = cmat = None
        if coco_dump_dir is not None:
            from yolov5m_tpu_torch.eval.coco_dump import CocoDump
            dump = CocoDump(class_names)
        if confusion_csv is not None:
            from yolov5m_tpu_torch.eval.confusion import ConfusionMatrix
            cmat = ConfusionMatrix(self.cfg.nc)
        t0 = time.perf_counter()
        host_s = 0.0
        model = self.fused_model(state_dict)
        dev = model.backbone[0].cbl[0].weight.device
        anchors_norm = torch.from_numpy(self.anchors_norm).to(dev)
        anchors_px = torch.from_numpy(self.anchors_px).to(dev)
        image_id, n_images = 0, 0
        mapm = MeanAveragePrecision()
        counts = np.zeros(4)

        def start(it):
            batch = next(it, None)
            return (None if batch is None else
                    self._start(model, batch, anchors_norm, anchors_px))

        it = iter(loader)
        pending = start(it)
        while pending is not None:
            batch, (det, det_valid, c), event = pending
            if self.overlap:
                pending = start(it)         # queue the next before waiting
            if event is not None:
                event.synchronize()
            t_host = time.perf_counter()
            h, w = batch["image"].shape[1:3]
            counts += c.numpy()
            det, det_valid = det.numpy(), det_valid.numpy()
            image_valid = np.asarray(batch.get(
                "image_valid", np.ones(det.shape[0], bool)))
            orig_hw = np.asarray(batch.get(
                "orig_hw", np.tile([h, w], (det.shape[0], 1))))
            for b in range(det.shape[0]):
                if not image_valid[b]:
                    continue
                keep = det_valid[b]
                gt = batch["labels"][b][batch["mask"][b]]
                gt_xyxy = (xywhn_to_xyxy_np(gt[:, 1:5], w=w, h=h) if len(gt)
                           else np.zeros((0, 4), np.float32))
                h0, w0 = int(orig_hw[b, 0]), int(orig_hw[b, 1])
                sx, sy = w0 / w, h0 / h
                preds = dict(boxes=det[b][keep][:, 2:6],
                             scores=det[b][keep][:, 1],
                             labels=det[b][keep][:, 0])
                targets = dict(boxes=gt_xyxy, labels=gt[:, 0])
                mapm.update(preds=preds, targets=targets,
                            area_scale=sx * sy)
                if dump is not None:
                    scale = np.asarray([sx, sy, sx, sy], np.float32)
                    dump.add_image(image_id, w0, h0,
                                   det[b][keep][:, 2:6] * scale,
                                   det[b][keep][:, 1], det[b][keep][:, 0],
                                   gt_xyxy * scale, gt[:, 0])
                if cmat is not None:
                    cmat.update(preds=preds, targets=targets)
                image_id += 1
            n_images += det.shape[0]
            host_s += time.perf_counter() - t_host
            if not self.overlap:
                pending = start(it)

        t_host = time.perf_counter()
        if dump is not None:
            paths = dump.write(coco_dump_dir)
            print(f"=> COCO-format eval dump: {paths['results']}")
        if cmat is not None:
            cmat.save_csv(confusion_csv, class_names)
            print(f"=> confusion matrix: {confusion_csv}")
        m = mapm.compute()
        host_s += time.perf_counter() - t_host
        self.timing = {"seconds": time.perf_counter() - t0,
                       "images": n_images, "host_seconds": host_s}
        return {
            "class_accuracy": float(counts[0] / (counts[1] + 1e-16)),
            "obj_accuracy": float(counts[2] / (counts[3] + 1e-16)),
            "map50": m["map_50"],
            "map75": m["map_75"],
            "map": m["map"],
            "map_small": m.get("map_small", -1.0),
            "map_medium": m.get("map_medium", -1.0),
            "map_large": m.get("map_large", -1.0),
            "ap_per_class": m.get("ap_per_class", {}),
        }
