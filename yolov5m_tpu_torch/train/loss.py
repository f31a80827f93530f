"""YOLOv5 detection loss on the device: port of ``yolov5m_tpu/train/loss.py``.

Two kinds, as in the JAX package:

  * "custom"      - grid targets (best anchor per scale), box IoU loss
                    (GIoU by default), IoU-weighted objectness BCE with the
                    per-scale balance BALANCE, one-hot class BCE;
  * "ultralytics" - candidate matching (anchor-ratio filter plus
                    neighbour cells).

Cells marked "ignore" are excluded from the objectness BCE of the custom
kind. Every part is a masked mean num/den with den clamped to 1, and the
total is scaled by the batch size. Predictions may be bf16: the loss
gathers the rows it needs first and casts only them (and the objectness
channel) to f32. The objectness targets are scattered with ``amax``, so
duplicate cells give the same target in any order.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from yolov5m_tpu_torch.config import Config
from yolov5m_tpu_torch.ops.boxes import box_iou
from yolov5m_tpu_torch.train.targets import (build_flat_targets,
                                             build_sparse_grid_targets)

BALANCE = (4.0, 1.0, 0.4)   # per-scale objectness weights, P3/P4/P5
PARTS = ("box", "obj", "cls")


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Scale-invariant lambda weights and the loss options."""

    nc: int = 80
    nl: int = 3
    image_size: int = 640
    anchor_t: float = 4.0
    ignore_iou_thresh: float = 0.5
    iou_type: str = "giou"          # giou | ciou | diou | iou
    label_smoothing: float = 0.0    # cls BCE targets become 1-e/2 and e/2
    focal_gamma: float = 0.0        # focal modulation of cls/obj BCE (0 = off)

    @property
    def cls_pos(self) -> float:
        return 1.0 - 0.5 * self.label_smoothing

    @property
    def cls_neg(self) -> float:
        return 0.5 * self.label_smoothing

    @property
    def lambda_class(self) -> float:
        return 0.5 * (self.nc / 80 * 3 / self.nl)

    @property
    def lambda_obj(self) -> float:
        return 1.0 * ((self.image_size / 640) ** 2 * 3 / self.nl)

    @property
    def lambda_box(self) -> float:
        return 0.05 * (3 / self.nl)

    @classmethod
    def from_config(cls, cfg: Config) -> "LossConfig":
        return cls(nc=cfg.nc, image_size=cfg.image_size,
                   anchor_t=cfg.anchor_t,
                   ignore_iou_thresh=cfg.ignore_iou_thresh,
                   iou_type=cfg.iou_type,
                   label_smoothing=cfg.label_smoothing,
                   focal_gamma=cfg.focal_gamma)


def bce_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross entropy with logits (numerically stable)."""
    return (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def focal_bce_logits(logits: torch.Tensor, labels: torch.Tensor,
                     gamma: float, alpha: float = 0.25) -> torch.Tensor:
    """Focal loss on BCE with logits: modulating factor (1-p_t)^gamma and
    alpha balancing on the elementwise BCE."""
    bce = bce_logits(logits, labels)
    p = torch.sigmoid(logits)
    p_t = labels * p + (1.0 - labels) * (1.0 - p)
    alpha_t = labels * alpha + (1.0 - labels) * (1.0 - alpha)
    return bce * alpha_t * (1.0 - p_t) ** gamma


def _sum_count(x: torch.Tensor, mask: torch.Tensor):
    """Masked-mean numerator and denominator."""
    m = mask.to(x.dtype)
    return (x * m).sum(), m.sum()


def _stack_parts(box, obj, cls):
    """[(num, den)] per scale -> ({"box","obj","cls"}: (nl,)) nums, dens."""
    parts = {"box": box, "obj": obj, "cls": cls}
    nums = {k: torch.stack([n for n, _ in v]) for k, v in parts.items()}
    dens = {k: torch.stack([d for _, d in v]) for k, v in parts.items()}
    return nums, dens


def _gather_rows(p: torch.Tensor, m: dict) -> torch.Tensor:
    """The prediction rows at the target cells, cast to f32."""
    return p[m["b"], m["a"], m["gj"], m["gi"]].float()


def _obj_target(p: torch.Tensor, m: dict, iou: torch.Tensor) -> torch.Tensor:
    """(bs, na, ny, nx) f32 objectness targets: the detached IoU, clamped at
    0, of the valid rows, scattered to their cells by max."""
    bs, na, ny, nx = p.shape[:4]
    idx = ((m["b"] * na + m["a"]) * ny + m["gj"]) * nx + m["gi"]
    iou_d = iou.detach().clamp(min=0.0)
    vals = torch.where(m["valid"], iou_d, torch.zeros_like(iou_d))
    tobj = torch.zeros(bs * na * ny * nx, dtype=torch.float32, device=p.device)
    tobj.scatter_reduce_(0, idx, vals, "amax", include_self=True)
    return tobj.view(bs, na, ny, nx)


class YoloLoss:
    """Callable loss; ``loss(preds, labels, mask)`` is a function of its
    tensors, differentiable with respect to the predictions.
    ``with_group`` gives its data-parallel twin (the JAX ``axis_name``)."""

    def __init__(self, lc: LossConfig, anchors_px, kind: str = "custom",
                 strides: Sequence[int] = (8, 16, 32)):
        if kind not in ("custom", "ultralytics"):
            raise ValueError(f"unknown loss kind {kind!r}")
        self.lc = lc
        self.anchors_px = torch.as_tensor(anchors_px, dtype=torch.float32)
        self.kind = kind
        self.strides = tuple(strides)
        self.group = None
        # device -> (anchors_px, BALANCE) there: made once, since a small
        # host-to-card copy waits for the card's stream
        self._consts = {}

    def with_group(self, group) -> "YoloLoss":
        """A copy of this loss, global over the process group ``group``
        (see ``__call__``)."""
        other = copy.copy(self)
        other.group = group
        return other

    def _on(self, device):
        c = self._consts.get(device)
        if c is None:
            c = self._consts[device] = (
                self.anchors_px.to(device),
                torch.tensor(BALANCE, dtype=torch.float32, device=device))
        return c

    def _bce(self, logits, labels):
        if self.lc.focal_gamma > 0:
            return focal_bce_logits(logits, labels, self.lc.focal_gamma)
        return bce_logits(logits, labels)

    def _smooth_one_hot(self, cls_idx):
        lc = self.lc
        # a comparison, not F.one_hot, whose range check waits for the card
        oh = (cls_idx[:, None] == torch.arange(
            lc.nc, device=cls_idx.device)).float()
        if lc.label_smoothing > 0:
            oh = oh * (lc.cls_pos - lc.cls_neg) + lc.cls_neg
        return oh

    def _box_iou(self, pbox, tbox):
        t = self.lc.iou_type
        return box_iou(pbox, tbox, giou=(t == "giou"), diou=(t == "diou"),
                       ciou=(t == "ciou"))[..., 0]

    def __call__(self, preds: Sequence[torch.Tensor], labels: torch.Tensor,
                 label_mask: torch.Tensor
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """preds: list of (bs, na, ny, nx, 5+nc) raw logits; labels: (bs, nb,
        5) (class, x, y, w, h) normalized; label_mask: (bs, nb) bool.
        Returns (total, {"box", "obj", "cls"}), total scaled by bs.

        With a group, the result is this rank's share of the global loss:
        compose(local nums, the group's summed dens, bs * world size).
        compose is linear in nums for fixed dens, so the shares of all
        ranks sum to the loss of the global batch and their gradients,
        summed over ranks, to its gradient. The nums are not all-reduced:
        through autograd that would make every rank's total the global
        loss, and the summed gradients world-size times too large."""
        nums, dens = self.num_den(preds, labels, label_mask)
        bs = preds[0].shape[0]
        if self.group is not None:
            flat = torch.stack([dens[k] for k in PARTS]).detach()
            dist.all_reduce(flat, group=self.group)
            dens = dict(zip(PARTS, flat.unbind(0)))
            bs *= dist.get_world_size(self.group)
        return self.compose(nums, dens, bs)

    def num_den(self, preds, labels, label_mask) -> Tuple[dict, dict]:
        """Per-scale masked-mean numerators and denominators of every part:
        two {"box", "obj", "cls"} dicts of (nl,) f32 tensors."""
        if self.kind == "custom":
            return self._custom_num_den(preds, labels, label_mask)
        return self._ultralytics_num_den(preds, labels, label_mask)

    def compose(self, nums: dict, dens: dict, bs: int):
        """(total, parts) from num_den's output; bs scales the total."""
        lc = self.lc
        bal = self._on(nums["obj"].device)[1]
        lbox = (nums["box"] / dens["box"].clamp(min=1.0)).sum()
        lobj = (nums["obj"] / dens["obj"].clamp(min=1.0) * bal).sum()
        lcls = (nums["cls"] / dens["cls"].clamp(min=1.0)).sum()
        total = (lc.lambda_box * lbox + lc.lambda_obj * lobj
                 + lc.lambda_class * lcls) * bs
        return total, {"box": lc.lambda_box * lbox,
                       "obj": lc.lambda_obj * lobj,
                       "cls": lc.lambda_class * lcls}

    def _custom_num_den(self, preds, labels, label_mask):
        lc = self.lc
        anchors_px = self._on(preds[0].device)[0]
        grid_sizes = [(p.shape[2], p.shape[3]) for p in preds]
        per_scale = build_sparse_grid_targets(
            labels, label_mask, anchors_px, grid_sizes, lc.ignore_iou_thresh)
        box, obj, cls = [], [], []
        for s, (p, m) in enumerate(zip(preds, per_scale)):
            anchors = anchors_px[s] / float(self.strides[s])   # cell units
            valid = m["valid"]
            rows = _gather_rows(p, m)
            pxy = torch.sigmoid(rows[..., 0:2]) * 2.0 - 0.5
            pwh = (torch.sigmoid(rows[..., 2:4]) * 2.0) ** 2 * anchors[m["a"]]
            iou = self._box_iou(torch.cat([pxy, pwh], -1), m["tbox"])
            box.append(_sum_count(1.0 - iou, valid))

            obj_bce = self._bce(p[..., 4].float(), _obj_target(p, m, iou))
            obj.append(_sum_count(obj_bce, ~m["ign"]))

            cls_bce = self._bce(rows[..., 5:], self._smooth_one_hot(m["tcls"]))
            cls.append(_sum_count(cls_bce, valid[:, None].expand_as(cls_bce)))
        return _stack_parts(box, obj, cls)

    def _ultralytics_num_den(self, preds, labels, label_mask):
        lc = self.lc
        grid_sizes = [(p.shape[2], p.shape[3]) for p in preds]
        per_scale = build_flat_targets(labels, label_mask,
                                       self._on(preds[0].device)[0],
                                       grid_sizes, lc.anchor_t, self.strides)
        box, obj, cls = [], [], []
        for p, m in zip(preds, per_scale):
            valid = m["valid"]
            rows = _gather_rows(p, m)
            pxy = torch.sigmoid(rows[..., 0:2]) * 2.0 - 0.5
            pwh = (torch.sigmoid(rows[..., 2:4]) * 2.0) ** 2 * m["anchor_wh"]
            iou = self._box_iou(torch.cat([pxy, pwh], -1), m["tbox"])
            box.append(_sum_count(1.0 - iou, valid))

            # plain mean over the full grid: this kind has no ignore cells
            obj_bce = self._bce(p[..., 4].float(), _obj_target(p, m, iou))
            obj.append(_sum_count(obj_bce, torch.ones_like(obj_bce,
                                                           dtype=torch.bool)))

            if lc.nc > 1:
                cls_bce = self._bce(rows[..., 5:],
                                    self._smooth_one_hot(m["tcls"]))
                cls.append(_sum_count(cls_bce,
                                      valid[:, None].expand_as(cls_bce)))
            else:
                zero = torch.zeros((), dtype=torch.float32, device=p.device)
                cls.append((zero, zero))
        return _stack_parts(box, obj, cls)
