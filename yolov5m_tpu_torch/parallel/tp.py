"""Tensor-parallel (TP) inference and training: output channels sharded
over a "model" axis.

Port of ``yolov5m_tpu/parallel/tp.py``. There only the parameters are
annotated and GSPMD propagates the channel shardings and inserts the
activation gathers; here ``ChannelOps`` writes them out. Every conv's
weights (OIHW) are split along O, and every per-channel vector (bias, BN
weight, bias and running statistics) along its one dim, wherever n_model
divides them (``variable_pspec``); anything else replicates, such as the
head's 255 channels at n_model 2, and a replicated layer is computed once,
on the model axis's first device. So within a batch shard a value is a
list of channel chunks, chunk m on the model axis's m-th device:

  * a conv reads every input channel: the chunks are gathered, in channel
    order, on each device that computes a chunk of the output;
  * BatchNorm, SiLU, the max-pools, the upsample and the residual adds
    are channel-local and run on the chunks where they lie;
  * a concat (C3, SPPF, the neck's joins) is the list of its operands'
    chunks, so the next conv's gather puts the channels back in order;
  * the head's logits are gathered on the first device before the loss or
    ``fused_detect``, which runs once a batch.

BN statistics are channel-local; with a data axis they reduce over the
batch shards too, so the step is the single-device step on the global
batch, as in JAX. Scaling across cards is not measured.

The int8 models split their ``w_q``, ``s_w`` and ``bias`` rows by the
same rule (``variable_pspec`` on the int8 tree, JAX's on its quantized
tree); their codes are NHWC, gathered along dim 3. In the chain each
operand of a concat is gathered whole before its ``conv_int8``, so that
its int32 sum runs over the operand's full K and the operands' f32
contributions add in the one-device order.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from yolov5m_tpu_torch.ops.postprocess import fused_detect
from yolov5m_tpu_torch.parallel.grid import (STEPS, Ops, Weights,
                                             conv_geometry, head_layout,
                                             maxpool_piece)
from yolov5m_tpu_torch.parallel.mesh import Mesh, resolve_data_axis


def variable_pspec(leaf, n_model: int, model_axis: str = "model") -> tuple:
    """The TP sharding of one parameter or buffer, as a partition spec
    (a tuple, one entry a dim): a conv weight (OIHW, ndim 4) splits its O
    dim when n_model divides it, a per-channel vector (ndim 1) its dim 0
    when n_model divides it and it has at least n_model entries;
    everything else (scalars, odd widths such as the head at nc 80 and
    n_model 2) replicates, (). JAX's rule on HWIO kernels, transposed."""
    shape = tuple(getattr(leaf, "shape", ()))
    if len(shape) == 4 and shape[0] % n_model == 0:
        return (model_axis, None, None, None)
    if len(shape) == 1 and shape[0] % n_model == 0 and shape[0] >= n_model:
        return (model_axis,)
    return ()


def _chunk_rows(n: int, n_model: int, m: int) -> Tuple[int, int]:
    per = n // n_model
    return (m * per, (m + 1) * per)


def shard_variables_tp(variables: Dict[str, torch.Tensor], mesh: Mesh,
                       model_axis: str = "model",
                       data_axis: Optional[str] = "data") -> dict:
    """The TP placement of a state dict: {name: a grid [data][model] of
    tensors}, cell (d, m) on its device holding chunk m of a sharded leaf
    (``variable_pspec``) or the whole of a replicated one."""
    data_axis = resolve_data_axis(data_axis, mesh, reserved=(model_axis,))
    grid = mesh.grid(data_axis, model_axis)
    n_model = mesh.shape[model_axis]
    out = {}
    for name, t in variables.items():
        if not torch.is_tensor(t):
            out[name] = t
            continue
        split = bool(variable_pspec(t, n_model, model_axis))
        out[name] = [[(t[slice(*_chunk_rows(t.shape[0], n_model, m))]
                       if split else t).to(dev, non_blocking=True)
                      for m, dev in enumerate(row)] for row in grid]
    return out


def shard_state_tp(state: dict, mesh: Mesh, model_axis: str = "model",
                   data_axis: Optional[str] = "data") -> dict:
    """A trainer's state dict (``Trainer.state_dict()``) with every tensor
    leaf placed as ``shard_variables_tp`` places it: model parameters and
    buffers, the EMA, the accumulated gradients and the Adam moments
    (param-shaped leaves shard, scalars and odd widths replicate). The TP
    trainer itself keeps the master copy on the first device; this is the
    layout its per-step copies take, for inspection and for placing a
    state on a grid."""
    def place(tree):
        if torch.is_tensor(tree):
            return shard_variables_tp({"": tree}, mesh, model_axis,
                                      data_axis)[""]
        if isinstance(tree, dict):
            return {k: place(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(place(v) for v in tree)
        return tree
    return place(state)


class ChannelOps(Ops):
    """A value is, per batch shard, a list of channel chunks in channel
    order; a chunk of a sharded layer's output lies on the model axis's
    device of its index, a replicated layer's one chunk on the first."""

    def __init__(self, model, weights: Weights, train: bool, grid):
        super().__init__(model, weights, train)
        self.grid = grid
        self.n_model = len(grid[0])

    def map(self, fn, *xs):
        return [[fn(*ts) for ts in zip(*chunks)] for chunks in zip(*xs)]

    def _full_on(self, chunks: List[torch.Tensor], dev) -> torch.Tensor:
        """The chunks on ``dev``, joined along their channels (dim 1 of
        NCHW floats, dim 3 of NHWC int8 codes)."""
        parts = [c.to(dev, non_blocking=True) for c in chunks]
        if len(parts) == 1:
            return parts[0]
        return torch.cat(parts, 3 if parts[0].dtype == torch.int8 else 1)

    def conv_pieces(self, m, xs, fn):
        _, _, p, weight = conv_geometry(m)
        o = weight.shape[0]
        split = bool(variable_pspec(weight, self.n_model))
        out = []
        for d, row in enumerate(self.grid):
            fulls = {}                     # one gather an operand a device

            def full(dev):
                if dev not in fulls:
                    fulls[dev] = [self._full_on(x[d], dev) for x in xs]
                return fulls[dev]

            if split:
                out.append([fn(full(dev), _chunk_rows(o, self.n_model, i), p)
                            for i, dev in enumerate(row)])
            else:
                out.append([fn(full(row[0]), None, p)])
        return out

    def bn(self, m, x):
        c = m.running_mean.shape[0]
        n_chunks = len(x[0])
        rows = ([None] if n_chunks == 1
                else [_chunk_rows(c, n_chunks, k) for k in range(n_chunks)])
        if not self.train:
            return [[self.bn_eval_piece(m, t, r) for t, r in zip(chunks, rows)]
                    for chunks in x]
        out = [[None] * n_chunks for _ in x]
        for k, r in enumerate(rows):
            ys = self.bn_global(m, [chunks[k] for chunks in x], r)
            for d, y in enumerate(ys):
                out[d][k] = y
        return out

    def maxpool_pieces(self, x):
        return self.map(maxpool_piece, x)

    def cat_pieces(self, xs):
        return [sum(parts, []) for parts in zip(*xs)]

    def head_pieces(self, head, feats):
        no = 5 + head.nc
        out = []
        for conv, f in zip(head.out_convs, feats):
            y = self.conv(conv, f)
            out.append([head_layout(self._full_on(chunks, row[0]), head.na,
                                    no) for row, chunks in zip(self.grid, y)])
        return out

    def ingress(self, images: torch.Tensor, normalize: bool = False):
        bs = images.shape[0]
        n_data = len(self.grid)
        if bs % n_data:
            raise ValueError(f"batch {bs} is not a multiple of the "
                             f"{n_data} devices of the data axis")
        per = bs // n_data
        return [[self.prep(images[d * per:(d + 1) * per], row[0], normalize)]
                for d, row in enumerate(self.grid)]


def tp_forward(model, mesh: Mesh, images: torch.Tensor,
               model_axis: str = "model", data_axis: Optional[str] = "data",
               weights: Optional[Weights] = None, normalize: bool = False):
    """The model's forward over the mesh: [P3, P4, P5] logits of the whole
    batch on the mesh's first device."""
    data_axis = resolve_data_axis(data_axis, mesh, reserved=(model_axis,))
    grid = mesh.grid(data_axis, model_axis)
    ops = ChannelOps(model, weights or Weights(), model.training, grid)
    vals = ops.run({"x0": ops.ingress(images, normalize)}, STEPS)
    out = grid[0][0]
    return [torch.cat([p.to(out, non_blocking=True) for p in per_scale])
            for per_scale in vals["out"]]


def make_tp_infer_fn(model, anchors_norm, mesh: Mesh,
                     model_axis: str = "model",
                     data_axis: Optional[str] = "data",
                     strides: Tuple[int, ...] = (8, 16, 32),
                     conf_threshold: float = 0.25,
                     iou_threshold: float = 0.45,
                     max_detections: int = 300,
                     pre_nms_topk: int = 1024,
                     backend: str = "auto",
                     uint8_ingress: bool = False) -> Callable:
    """Build ``infer(images) -> (det, valid)`` over ``mesh``.

    model: a fused (BN-folded) or plain float YOLOv5, or an int8 one
    (``quant`` "chain" or "block"), used in eval mode; its parameters and buffers are copied to the mesh at the first call,
    as ``shard_variables_tp`` lays them out. images: (bs, H, W, 3), bs a
    multiple of the data axis; float, or uint8 with ``uint8_ingress``, the
    normalize then running on the devices in the model's dtype (the
    server's ingress). Pass ``data_axis=None`` for a 1-D model mesh.

    Returns (bs, max_detections, 6) and (bs, max_detections) on the mesh's
    first device, in batch order: one ``fused_detect`` a batch."""
    model = model.eval()
    data_axis = resolve_data_axis(data_axis, mesh, reserved=(model_axis,))
    weights = Weights()
    anchors = torch.as_tensor(anchors_norm, dtype=torch.float32,
                              device=mesh.devices.flat[0])
    kw = dict(strides=strides, conf_threshold=conf_threshold,
              iou_threshold=iou_threshold, max_detections=max_detections,
              pre_nms_topk=pre_nms_topk, backend=backend)

    @torch.inference_mode()
    def tp_infer(images: torch.Tensor):
        preds = tp_forward(model, mesh, images, model_axis, data_axis,
                           weights, normalize=uint8_ingress)
        return fused_detect(preds, anchors, **kw)

    return tp_infer


def make_tp_train_step(model, loss_fn, optimizer, mesh: Mesh,
                       accumulate: int = 1, model_axis: str = "model",
                       data_axis: Optional[str] = "data"):
    """TP training: a ``Trainer`` whose forward runs over ``mesh``; its
    ``train_step(image, labels, mask)`` is the single-device step on the
    global batch. The master parameters, the optimizer's moments and the
    EMA stay where the model lives (normally the mesh's first device);
    each step copies every leaf's chunk to the device that computes it,
    and autograd sums the chunks' gradients back."""
    from yolov5m_tpu_torch.train.trainer import Trainer

    resolve_data_axis(data_axis, mesh, reserved=(model_axis,))

    def forward(images):
        return tp_forward(model, mesh, images, model_axis, data_axis)

    return Trainer(model, loss_fn, optimizer, accumulate, forward=forward)
