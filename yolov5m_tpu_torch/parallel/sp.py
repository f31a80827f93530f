"""Spatially partitioned (SP) inference and training: the rows of the conv
grid sharded over a "spatial" axis, with halo exchange.

Port of ``yolov5m_tpu/parallel/sp.py``. There GSPMD partitions one jitted
program and inserts the halo exchanges itself; here they are written out
(``SpatialOps``). A shard holds rows [r0, r1) of every activation, with r1 -
r0 the same for every shard. Before a window op it receives the rows its
window reaches beyond them from its neighbours:

  * a conv with kernel k, stride s and row padding p reads p rows above
    the shard and k - s - p below (6x6 s2 p2 stem: 2 / 2; 3x3 s1: 1 / 1;
    3x3 s2: 1 / 0; 1x1: none), and runs with no row padding;
  * each of the SPPF's three 5x5 max-pools reads 2 / 2;
  * at the image's top and bottom edges the missing rows are the op's own
    padding: zeros for a conv, -inf for a max-pool.

Rows that a neighbour lacks come from the next shard on, so a shard of one
row (P5 of 128 px over 4 shards) still sees its whole window. The nearest
2x upsample, the concats, the residual adds and the space-to-depth stem
are local. Training BatchNorm reduces its statistics over every shard,
rows and batch (the single-device step on the global batch, as GSPMD's
partitioning of it is); the head's logits are gathered to the first device
before the loss or ``fused_detect``, which runs once a batch.

With a data axis the batch is sharded over it as well: device (d, s) holds
batch rows [d*bs/D, (d+1)*bs/D) and image rows [s*H/S, (s+1)*H/S).
H must be divisible by 32 x n_spatial, so that every shard keeps whole
rows at every stride (and even rows for the stride-2 ops).

Scaling across cards is not measured: one process launches every
shard's work in turn, and on several cards the shards overlap only by
CUDA's asynchrony.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from yolov5m_tpu_torch.ops.postprocess import fused_detect
from yolov5m_tpu_torch.parallel.grid import (STEPS, Ops, Weights,
                                             check_float_model, head_layout)
from yolov5m_tpu_torch.parallel.mesh import Mesh, resolve_data_axis

NEG_INF = float("-inf")


def _format_like(z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    if t.dim() == 4 and not t.is_contiguous() and t.is_contiguous(
            memory_format=torch.channels_last):
        return z.contiguous(memory_format=torch.channels_last)
    return z


def _rows_from(row: list, s: int, n: int, fill: float, above: bool):
    """The n rows just above (or below) shard s of one batch shard's list
    of row shards, on shard s's device: from shard s-1 (s+1) and on past
    it where a shard is shorter than n; past the image's edge, rows of
    ``fill``."""
    t = row[s]
    parts, need = [], n
    j = s - 1 if above else s + 1
    while need and 0 <= j < len(row):
        h = row[j].shape[2]
        take = min(need, h)
        piece = row[j][:, :, h - take:] if above else row[j][:, :, :take]
        parts.append(piece.to(t.device, non_blocking=True))
        need -= take
        j += -1 if above else 1
    if need:
        b, c, _, w = t.shape
        parts.append(_format_like(t.new_full((b, c, need, w), fill), t))
    if above:
        parts.reverse()
    return parts


class SpatialOps(Ops):
    """A value is a grid [data][spatial] of row shards, shard (d, s) on
    ``grid[d][s]``."""

    def __init__(self, model, weights: Weights, train: bool, grid):
        super().__init__(model, weights, train)
        self.grid = grid

    def map(self, fn, *xs):
        return [[fn(*ts) for ts in zip(*rows)] for rows in zip(*xs)]

    def halo(self, x, top: int, bottom: int, fill: float):
        """Each shard with ``top`` rows above and ``bottom`` below."""
        out = []
        for row in x:
            new = []
            for s, t in enumerate(row):
                parts = (_rows_from(row, s, top, fill, True) + [t]
                         + _rows_from(row, s, bottom, fill, False))
                new.append(torch.cat(parts, 2) if len(parts) > 1 else t)
            out.append(new)
        return out

    def conv(self, m, x):
        k, s, p = m.kernel_size[0], m.stride[0], m.padding[0]
        ext = self.halo(x, p, k - s - p, 0.0)
        pad = (0, m.padding[1])
        return self.map(lambda t: self.conv_piece(m, t, padding=pad), ext)

    def bn(self, m, x):
        if not self.train:
            return self.map(lambda t: self.bn_eval_piece(m, t), x)
        flat = self.bn_global(m, [t for row in x for t in row])
        n = len(x[0])
        return [flat[d * n:(d + 1) * n] for d in range(len(x))]

    def maxpool(self, x):
        ext = self.halo(x, 2, 2, NEG_INF)
        return self.map(lambda t: F.max_pool2d(t, 5, 1, (0, 2)), ext)

    def cat(self, xs):
        return self.map(lambda *ts: torch.cat(ts, 1), *xs)

    def head(self, head, feats):
        """Per scale, per batch shard: the row shards' logits gathered on
        the batch shard's first device, (bs/D, na, ny, nx, no)."""
        no = 5 + head.nc
        out = []
        for conv, f in zip(head.out_convs, feats):
            y = self.conv(conv, f)
            out.append([torch.cat([head_layout(t, head.na, no).to(
                self.grid[d][0], non_blocking=True) for t in row], 2)
                for d, row in enumerate(y)])
        return out

    def ingress(self, images: torch.Tensor):
        bs, h, w = images.shape[:3]
        n_data, n_sp = len(self.grid), len(self.grid[0])
        if bs % n_data:
            raise ValueError(f"batch {bs} is not a multiple of the "
                             f"{n_data} devices of the data axis")
        if h % (32 * n_sp) or w % 32:
            raise ValueError(
                f"SP over {n_sp} row shards needs H divisible by 32 x "
                f"{n_sp} = {32 * n_sp} (whole rows a shard at every "
                f"stride) and W by 32, got {h}x{w}")
        per, hs = bs // n_data, h // n_sp
        return [[self.prep(images[d * per:(d + 1) * per, s * hs:(s + 1) * hs],
                           self.grid[d][s])
                 for s in range(n_sp)] for d in range(n_data)]


def sp_forward(model, mesh: Mesh, images: torch.Tensor,
               spatial_axis: str = "spatial",
               data_axis: Optional[str] = "data",
               weights: Optional[Weights] = None):
    """The model's forward over the mesh: [P3, P4, P5] logits on the
    mesh's first device, the whole batch, as ``model(images)`` gives them
    (in training, BN statistics over the global batch)."""
    check_float_model(model, "SP")
    data_axis = resolve_data_axis(data_axis, mesh, reserved=(spatial_axis,))
    grid = mesh.grid(data_axis, spatial_axis)
    ops = SpatialOps(model, weights or Weights(), model.training, grid)
    vals = ops.run({"x0": ops.ingress(images)}, STEPS)
    out = grid[0][0]
    return [torch.cat([p.to(out, non_blocking=True) for p in per_scale])
            for per_scale in vals["out"]]


def make_sp_infer_fn(model, anchors_norm, mesh: Mesh,
                     spatial_axis: str = "spatial",
                     data_axis: Optional[str] = "data",
                     strides: Tuple[int, ...] = (8, 16, 32),
                     conf_threshold: float = 0.25,
                     iou_threshold: float = 0.45,
                     max_detections: int = 300,
                     pre_nms_topk: int = 1024,
                     backend: str = "auto") -> Callable:
    """Build ``infer(images) -> (det, valid)`` over ``mesh``.

    model: a fused (BN-folded) or plain float YOLOv5; it is used in eval
    mode and its weights are copied to each device at the first call.
    images: (bs, H, W, 3) float on the host or a device; bs a multiple of
    the data axis, H of 32 x n_spatial. Pass ``data_axis=None`` for a 1-D
    spatial mesh (the default "data" falls back to it).

    Returns (bs, max_detections, 6) [class, conf, x1, y1, x2, y2] and a
    (bs, max_detections) valid mask on the mesh's first device, in batch
    order: one ``fused_detect`` (one NMS launch) a batch."""
    model = model.eval()
    resolve_data_axis(data_axis, mesh, reserved=(spatial_axis,))
    anchors = torch.as_tensor(anchors_norm, dtype=torch.float32,
                              device=mesh.devices.flat[0])
    weights = Weights()
    kw = dict(strides=strides, conf_threshold=conf_threshold,
              iou_threshold=iou_threshold, max_detections=max_detections,
              pre_nms_topk=pre_nms_topk, backend=backend)

    @torch.inference_mode()
    def sp_infer(images: torch.Tensor):
        preds = sp_forward(model, mesh, images, spatial_axis, data_axis,
                           weights)
        return fused_detect(preds, anchors, **kw)

    return sp_infer


def make_sp_train_step(model, loss_fn, optimizer, mesh: Mesh,
                       accumulate: int = 1,
                       spatial_axis: str = "spatial",
                       data_axis: Optional[str] = "data"):
    """SP training: a ``Trainer`` whose forward runs over ``mesh`` (the
    port's DP precedent, ``make_dp_train_step``; the JAX function returns
    a jitted ``step(state, ...)``). Its ``train_step(image, labels, mask)``
    is the single-device step on the global batch: the loss on the
    gathered logits, BN over every shard, the master parameters (where
    the model lives, normally the mesh's first device) updated once."""
    from yolov5m_tpu_torch.train.trainer import Trainer

    check_float_model(model, "SP")
    resolve_data_axis(data_axis, mesh, reserved=(spatial_axis,))

    def forward(images):
        return sp_forward(model, mesh, images, spatial_axis, data_axis)

    return Trainer(model, loss_fn, optimizer, accumulate, forward=forward)
