"""Spatially partitioned (SP) inference and training: the rows of the conv
grid sharded over a "spatial" axis, with halo exchange.

Port of ``yolov5m_tpu/parallel/sp.py``. There GSPMD partitions one jitted
program and inserts the halo exchanges itself; here they are written out
(``SpatialOps``). Every activation of height h is split by GSPMD's rule
(``split_rows``): c = ceil(h / n) rows a shard, shard i holding rows
[i*c, min((i+1)*c, h)), so the last shards may hold fewer rows, or none
(P5 of 64 px over 4 shards: 1, 1, 0, 0). An empty shard is ``None`` and
launches nothing.

Each window op computes the output rows its shard owns, [o0, o1): it
reads the input rows [o0*s - p, (o1-1)*s - p + k) from whichever shards
hold them (``gather_rows``), rows past the image's top and bottom edges
being the op's padding (zeros for a conv, -inf for a max-pool, -128 for
the int8 chain's), and runs with no row padding. The nearest 2x upsample
fetches its source rows the same way, since the splits of h and 2h need
not line up (P5 of 18 rows over 4 shards: 5/5/5/3; its upsample: 9/9/9/9,
so shard 1 reads P5 rows 4-8). Values of one height share one split, so
the concats, the residual adds and the elementwise ops are local.
Training BatchNorm reduces its statistics over every non-empty shard,
each weighted by its count of positions (the single-device step on the
global batch, as GSPMD's partitioning of it is); the head's logits are
gathered to the first device before the loss or ``fused_detect``, which
runs once a batch.

With a data axis the batch is sharded over it as well: device (d, s) holds
batch rows [d*bs/D, (d+1)*bs/D) and image rows [s*H/S, (s+1)*H/S). As in
JAX, H must be divisible by n_spatial (and, as the model asks, H and W by
32).

The int8 models run as on one device (``grid.Ops.cbl_int8``): their codes
are NHWC, so their rows are dim 1, and a conv's halo of codes is code 0,
exactly 0.0.

Scaling across cards is not measured: one process launches every
shard's work in turn, and on several cards the shards overlap only by
CUDA's asynchrony.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from yolov5m_tpu_torch.ops.postprocess import fused_detect
from yolov5m_tpu_torch.parallel.grid import (STEPS, Ops, Weights,
                                             conv_geometry, head_layout,
                                             maxpool_piece, upsample_piece)
from yolov5m_tpu_torch.parallel.mesh import Mesh, resolve_data_axis


def split_rows(h: int, n: int, i: int) -> Tuple[int, int]:
    """GSPMD's split of h rows over n shards: shard i holds [i*c,
    min((i+1)*c, h)), c = ceil(h / n); it may be empty."""
    c = -(-h // n)
    return min(i * c, h), min((i + 1) * c, h)


def _row_dim(t: torch.Tensor) -> int:
    """The rows' dim of a piece: NHWC int8 codes, else NCHW."""
    return 1 if t.dtype == torch.int8 else 2


def _height(row: list) -> int:
    return sum(t.shape[_row_dim(t)] for t in row if t is not None)


def _pool_fill(t: torch.Tensor) -> float:
    return -128 if t.dtype == torch.int8 else float("-inf")


def _fill_rows(ref: torch.Tensor, n: int, fill, device) -> torch.Tensor:
    shape = list(ref.shape)
    shape[_row_dim(ref)] = n
    z = ref.new_full(shape, fill, device=device)
    if ref.dim() == 4 and not ref.is_contiguous() and ref.is_contiguous(
            memory_format=torch.channels_last):
        z = z.contiguous(memory_format=torch.channels_last)
    return z


def gather_rows(row: list, lo: int, hi: int, device, fill) -> torch.Tensor:
    """Rows [lo, hi) of the value held as the row shards ``row`` (in order,
    None for an empty one), on ``device``, as one tensor: each from the
    shard that holds it, and rows past the image's edges (lo < 0, hi
    beyond the height) of ``fill``."""
    ref = next(t for t in row if t is not None)
    d = _row_dim(ref)
    parts: List[torch.Tensor] = []
    if lo < 0:
        parts.append(_fill_rows(ref, -lo, fill, device))
    start = 0
    for t in row:
        if t is None:
            continue
        h = t.shape[d]
        a, b = max(lo, start), min(hi, start + h)
        if a < b:
            piece = t if (a, b) == (start, start + h) else t.narrow(
                d, a - start, b - a)
            parts.append(piece.to(device, non_blocking=True))
        start += h
    if hi > start:
        parts.append(_fill_rows(ref, hi - max(lo, start), fill, device))
    return torch.cat(parts, d) if len(parts) > 1 else parts[0]


class SpatialOps(Ops):
    """A value is a grid [data][spatial] of row shards, shard (d, s) on
    ``grid[d][s]`` (None where it holds no rows)."""

    def __init__(self, model, weights: Weights, train: bool, grid):
        super().__init__(model, weights, train)
        self.grid = grid

    def map(self, fn, *xs):
        return [[None if ts[0] is None else fn(*ts) for ts in zip(*rows)]
                for rows in zip(*xs)]

    def conv_pieces(self, m, xs, fn):
        k, s, p, _ = conv_geometry(m)
        out = []
        for d, rows in enumerate(zip(*xs)):
            n = len(rows[0])
            ho = (_height(rows[0]) + 2 * p - k) // s + 1
            new = []
            for i in range(n):
                o0, o1 = split_rows(ho, n, i)
                if o0 == o1:
                    new.append(None)
                    continue
                dev = self.grid[d][i]
                ext = [gather_rows(r, o0 * s - p, (o1 - 1) * s - p + k, dev,
                                   0) for r in rows]
                new.append(fn(ext, None, (0, p)))
            out.append(new)
        return out

    def bn(self, m, x):
        if not self.train:
            return self.map(lambda t: self.bn_eval_piece(m, t), x)
        ys = iter(self.bn_global(m, [t for row in x for t in row
                                     if t is not None]))
        return [[None if t is None else next(ys) for t in row] for row in x]

    def maxpool_pieces(self, x):
        out = []
        for d, row in enumerate(x):
            new, start = [], 0
            for i, t in enumerate(row):
                if t is None:
                    new.append(None)
                    continue
                h = t.shape[_row_dim(t)]
                ext = gather_rows(row, start - 2, start + h + 2,
                                  self.grid[d][i], _pool_fill(t))
                new.append(maxpool_piece(ext, row_pad=0))
                start += h
            out.append(new)
        return out

    def upsample_pieces(self, x):
        out = []
        for d, row in enumerate(x):
            h, n = 2 * _height(row), len(row)
            new = []
            for i in range(n):
                o0, o1 = split_rows(h, n, i)
                if o0 == o1:
                    new.append(None)
                    continue
                src = gather_rows(row, o0 // 2, (o1 + 1) // 2,
                                  self.grid[d][i], 0)
                up = upsample_piece(src)
                new.append(up.narrow(_row_dim(up), o0 % 2, o1 - o0))
            out.append(new)
        return out

    def cat_pieces(self, xs):
        return self.map(lambda *ts: torch.cat(ts, 1), *xs)

    def head_pieces(self, head, feats):
        """Per scale, per batch shard: the row shards' logits gathered on
        the batch shard's first device, (bs/D, na, ny, nx, no)."""
        no = 5 + head.nc
        out = []
        for conv, f in zip(head.out_convs, feats):
            y = self.conv(conv, f)
            out.append([torch.cat([head_layout(t, head.na, no).to(
                self.grid[d][0], non_blocking=True) for t in row
                if t is not None], 2) for d, row in enumerate(y)])
        return out

    def ingress(self, images: torch.Tensor):
        """Shard (d, s) of the model's input: the stem's input split by
        ``split_rows``, which for the space-to-depth stem is half the
        image's rows."""
        bs, h, w = images.shape[:3]
        n_data, n_sp = len(self.grid), len(self.grid[0])
        if bs % n_data:
            raise ValueError(f"batch {bs} is not a multiple of the "
                             f"{n_data} devices of the data axis")
        if h % n_sp:
            raise ValueError(f"SP over {n_sp} row shards needs the image "
                             f"height divisible by {n_sp}, got {h}x{w}")
        if h % 32 or w % 32:
            raise ValueError(f"H and W must be divisible by 32, got {h}x{w}")
        per = bs // n_data
        f = 2 if self.model.stem_s2d else 1
        out = []
        for d in range(n_data):
            row = []
            for s in range(n_sp):
                o0, o1 = split_rows(h // f, n_sp, s)
                row.append(None if o0 == o1 else self.prep(
                    images[d * per:(d + 1) * per, f * o0:f * o1],
                    self.grid[d][s]))
            out.append(row)
        return out


def sp_forward(model, mesh: Mesh, images: torch.Tensor,
               spatial_axis: str = "spatial",
               data_axis: Optional[str] = "data",
               weights: Optional[Weights] = None):
    """The model's forward over the mesh: [P3, P4, P5] logits on the
    mesh's first device, the whole batch, as ``model(images)`` gives them
    (in training, BN statistics over the global batch)."""
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

    model: a fused (BN-folded) or plain float YOLOv5, or an int8 one
    (``quant`` "chain" or "block"); it is used in eval mode and its
    weights are copied to each device at the first call.
    images: (bs, H, W, 3) float on the host or a device; bs a multiple of
    the data axis, H of n_spatial (and of 32, W of 32). Pass ``data_axis=None`` for a 1-D
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

    resolve_data_axis(data_axis, mesh, reserved=(spatial_axis,))

    def forward(images):
        return sp_forward(model, mesh, images, spatial_axis, data_axis)

    return Trainer(model, loss_fn, optimizer, accumulate, forward=forward)
