"""The YOLOv5 forward as a linear program over named values, run by one
process over a grid of devices.

``parallel/sp.py``, ``tp.py`` and ``pp.py`` share what is here. The JAX
package hands those three to GSPMD and to a ``shard_map``ped ``lax.scan``;
PyTorch has no partitioner, so the port runs the model's blocks through an
``Ops`` object that holds a value as pieces on devices and writes out every
exchange:

  * ``ReplicaOps`` (PP, and the data replicas of DPxPP): one tensor a
    replica, each with its own BatchNorm statistics, running buffers
    averaged over replicas;
  * ``sp.SpatialOps``: one tensor a (replica, row shard), halo rows copied
    in from the neighbouring shards before every spatial window;
  * ``tp.ChannelOps``: per replica, the output channels as chunks, one a
    device of the model axis, gathered before every convolution.

Parameters stay where the model holds them (the master copy, on the grid's
first device in the entry points); ``Weights`` copies, casts and slices
them for the device that needs them. Those copies are differentiable, so
autograd sums the gradient of every copy into the master parameter, and a
layer is computed once per piece of its output, never once per device
from copies autograd does not join. Every device works on its current
stream: a copy between devices orders itself behind the producer's work,
so no stream needs to wait for another by hand.

Values are NCHW views, channels_last on the card, as inside ``YOLOv5``.
The int8 models (``quant`` "block" and "chain") run the arithmetic of
``CBL._quant_forward`` and ``_quant_chain_forward`` on each piece
(``Ops.cbl_int8``): a chain value is ``Codes``, its NHWC int8 pieces and
the scale they share, and a chain concat is ``Concat``, its operands
never joined, so that each piece sums its operands' f32 contributions in
the one-device order.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from yolov5m_tpu_torch.models.blocks import (BN_DECAY, BN_EPS, C3, CBL,
                                             SPPF, Bottleneck, conv_int8,
                                             dequantize, maxpool_int8,
                                             quantize_act, upsample2x_codes,
                                             upsample2x_nearest)
from yolov5m_tpu_torch.models.s2d import space_to_depth2
from yolov5m_tpu_torch.models.yolo import _recompute_context
from yolov5m_tpu_torch.ops.preprocess import normalize_uint8


# ---------------------------------------------------------------------------
# The forward as a linear program over named values: (value name, the
# names it reads, the module's state-dict prefix, fn(ops, model, vals)).
# ``models/yolo.py:YOLOv5.forward`` linearized, the JAX package's
# ``parallel/pp.py:_program`` step for step: the same modules, in the same
# order, with the same concat operands. "x0" is the input, "out" the head's
# three outputs.
# ---------------------------------------------------------------------------

def _program():
    steps = []

    def add(name, reads, module, fn):
        steps.append((name, tuple(reads), module, fn))

    def bb(i, rd):
        return lambda ops, m, v: ops.block(m.backbone[i], v[rd])

    def nk(i, rd):
        return lambda ops, m, v: ops.block(m.neck[i], v[rd])

    def nk_upcat(i, small, skip):
        # FPN joins: 2x nearest upsample of the stashed 1x1 output, then
        # the backbone tap
        return lambda ops, m, v: ops.block(m.neck[i], ops.cat(
            [ops.upsample(v[small]), v[skip]]))

    def nk_cat(i, a, b):
        # PAN joins
        return lambda ops, m, v: ops.block(m.neck[i], ops.cat([v[a], v[b]]))

    add("x1", ["x0"], "backbone.0", bb(0, "x0"))
    add("x2", ["x1"], "backbone.1", bb(1, "x1"))
    add("x3", ["x2"], "backbone.2", bb(2, "x2"))
    add("x4", ["x3"], "backbone.3", bb(3, "x3"))
    add("p3", ["x4"], "backbone.4", bb(4, "x4"))        # tap
    add("x6", ["p3"], "backbone.5", bb(5, "p3"))
    add("p4", ["x6"], "backbone.6", bb(6, "x6"))        # tap
    add("x8", ["p4"], "backbone.7", bb(7, "p4"))
    add("x9", ["x8"], "backbone.8", bb(8, "x8"))
    add("x10", ["x9"], "backbone.9", bb(9, "x9"))       # SPPF
    add("s20", ["x10"], "neck.0", nk(0, "x10"))         # stash
    add("x12", ["s20", "p4"], "neck.1", nk_upcat(1, "s20", "p4"))
    add("s40", ["x12"], "neck.2", nk(2, "x12"))         # stash
    add("f80", ["s40", "p3"], "neck.3", nk_upcat(3, "s40", "p3"))
    add("x14", ["f80"], "neck.4", nk(4, "f80"))
    add("f40", ["x14", "s40"], "neck.5", nk_cat(5, "x14", "s40"))
    add("x16", ["f40"], "neck.6", nk(6, "f40"))
    add("f20", ["x16", "s20"], "neck.7", nk_cat(7, "x16", "s20"))
    add("out", ["f80", "f40", "f20"], "head",
        lambda ops, m, v: ops.head(m.head, [v["f80"], v["f40"], v["f20"]]))
    return steps


STEPS = _program()
N_STEPS = len(STEPS)


def head_layout(y: torch.Tensor, na: int, no: int) -> torch.Tensor:
    """A head conv's NCHW output -> (bs, na, ny, nx, no), channel
    c = a*no + o, as ``models/yolo.py:Head`` lays it out."""
    y = y.permute(0, 2, 3, 1)
    bs, ny, nx, _ = y.shape
    return y.reshape(bs, ny, nx, na, no).permute(0, 3, 1, 2, 4)


def check_float_model(model, what: str) -> None:
    """PP pipelines the float graph: the int8 model is refused there, as
    the JAX package's ``StagePlan`` refuses it."""
    if getattr(model, "quant", None):
        raise ValueError(f"{what} pipelines the float graph; the int8 model "
                         f"(quant={model.quant!r}) runs on one device, or "
                         f"under SP or TP")


class Codes(NamedTuple):
    """An int8-chain value on a grid: its codes, held in pieces as the
    ``Ops`` subclass holds a value (each piece NHWC int8), and the f32
    scale they share (the model's buffer, copied to each piece's device
    where it is used)."""
    pieces: list
    scale: torch.Tensor


class Concat(tuple):
    """A concat of the int8 chain: its operands (``Codes``) in order, never
    joined. The next CBL convolves each against its slice of the weights'
    input channels (``CBL._quant_chain_forward``'s split convolution)."""


def conv_geometry(m) -> tuple:
    """(kernel, stride, padding, OIHW weight) of a float conv or of an int8
    CBL's convolution."""
    if isinstance(m, nn.Conv2d):
        return m.kernel_size[0], m.stride[0], m.padding[0], m.weight
    return m.w_q.shape[-1], m.stride, m.pad, m.w_q


def maxpool_piece(t: torch.Tensor, row_pad: int = 2) -> torch.Tensor:
    """The SPPF's 5x5 stride-1 max pool of one piece, its rows padded by
    ``row_pad`` and its columns by 2: NCHW float (-inf padding), or NHWC
    int8 codes (``maxpool_int8``'s -128 padding)."""
    if t.dtype == torch.int8:
        return maxpool_int8(t, row_pad=row_pad)
    return F.max_pool2d(t, 5, 1, (row_pad, 2))


def upsample_piece(t: torch.Tensor) -> torch.Tensor:
    """The nearest 2x upsample of one piece: NCHW float or NHWC codes."""
    if t.dtype == torch.int8:
        return upsample2x_codes(t)
    return upsample2x_nearest(t)


class Weights:
    """The parameters and buffers a grid reads, copied, cast and sliced
    for the device that needs them, each at most once while this object
    lives: one training step (copies stay differentiable), or an inference
    function's whole life."""

    def __init__(self):
        self._cache: Dict[tuple, tuple] = {}

    def get(self, t: torch.Tensor, device: torch.device,
            dtype: Optional[torch.dtype] = None,
            rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        key = (id(t), device, dtype, rows)
        hit = self._cache.get(key)
        if hit is not None and hit[0] is t:
            return hit[1]
        v = t if rows is None else t[rows[0]:rows[1]]
        v = v.to(device=device, dtype=dtype or v.dtype, non_blocking=True)
        self._cache[key] = (t, v)
        return v


def compute_dtype(model) -> torch.dtype:
    """The activations' dtype, as ``YOLOv5.forward`` picks it."""
    return model.compute_dtype or model.head.out_convs[0].weight.dtype


class Ops:
    """The blocks of ``models/blocks.py`` over a value held in pieces. A
    subclass says how a value is held (``map``) and supplies the ops that
    cross pieces: conv_pieces, bn, maxpool_pieces, cat_pieces,
    head_pieces, ingress (and upsample_pieces where the upsample crosses
    them)."""

    def __init__(self, model, weights: Weights, train: bool):
        self.model, self.w, self.train = model, weights, train
        self.dtype = compute_dtype(model)
        self.chain = getattr(model, "quant", None) == "chain"
        self.remat = model.remat and train and torch.is_grad_enabled()

    # -- the program ---------------------------------------------------

    def run(self, vals: dict, steps: Sequence) -> dict:
        for name, _, _, fn in steps:
            vals[name] = fn(self, self.model, vals)
        return vals

    def block(self, layer: nn.Module, x):
        """layer(x), checkpointed where the model's remat asks for it
        (``YOLOv5._block``): the recompute leaves the running statistics
        alone."""
        if not (self.remat and (self.model.remat_scope == "all"
                                or isinstance(layer, C3))):
            return self._run(layer, x)
        return checkpoint(self._run, layer, x, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=functools.partial(_recompute_context,
                                                       layer))

    def _run(self, layer: nn.Module, x):
        if isinstance(layer, CBL):
            return self.cbl(layer, x)
        if isinstance(layer, Bottleneck):
            if layer.chain:
                return self.residual_int8(layer, x)
            return self.add(self.cbl(layer.c2, self.cbl(layer.c1, x)), x)
        if isinstance(layer, nn.Sequential):
            for sub in layer:
                x = self._run(sub, x)
            return x
        if isinstance(layer, C3):
            y = self._run(layer.seq, self.cbl(layer.c1, x))
            skip = self.cbl(layer.c_skipped, x)
            return self.cbl(layer.c_out, self.cat([y, skip]))
        if isinstance(layer, SPPF):
            x = self.cbl(layer.c1, x)
            p1 = self.maxpool(x)
            p2 = self.maxpool(p1)
            p3 = self.maxpool(p2)
            return self.cbl(layer.c_out, self.cat([x, p1, p2, p3]))
        raise TypeError(f"no grid rule for {type(layer).__name__}")

    def cbl(self, m: CBL, x, emit_float: bool = False):
        if m.quant:
            return self.cbl_int8(m, x, emit_float)
        y = self.conv(m.cbl[0], x)
        if len(m.cbl) > 1:
            y = self.bn(m.cbl[1], y)
        return self.map(F.silu, y)

    def conv(self, m: nn.Conv2d, x):
        """The float conv m over x."""
        return self.conv_pieces(m, [x], lambda ts, rows, padding:
                                self.conv_piece(m, ts[0], rows, padding))

    def cbl_int8(self, m: CBL, x, emit_float: bool = False):
        """An int8 CBL on the grid. x: float pieces (the stem's input, or
        any input in per-block mode), quantized piece by piece against
        ``s_in``; ``Codes``; or a ``Concat`` of them. Each output piece
        gets the operands' codes its window reads (``conv_pieces``) and
        runs ``CBL``'s arithmetic on them: per operand ``conv_int8``
        against its weight columns, scaled in f32 and added in the
        operands' order, then the bias and SiLU; in per-block mode the
        float activation in the model's dtype (NCHW), in the chain the
        codes requantized against ``s_out`` (``Codes``) or, with
        emit_float, the f32 activation (NHWC pieces)."""
        operands = list(x) if isinstance(x, Concat) else [x]
        codes, scales = [], []
        for p in operands:
            if not isinstance(p, Codes):
                p = Codes(self.map(lambda t: quantize_act(
                    t.permute(0, 2, 3, 1).float(),
                    self.w.get(m.s_in, t.device)), p), m.s_in)
            codes.append(p.pieces)
            scales.append(p.scale)

        def piece(ts, rows, padding):
            dev = ts[0].device
            w_q = self.w.get(m.w_q, dev, rows=rows)
            s_w = self.w.get(m.s_w, dev, rows=rows)
            y, off = None, 0
            for q, s in zip(ts, scales):
                c = q.shape[-1]
                acc = conv_int8(q, w_q[:, off:off + c], m.stride, padding)
                contrib = acc.float().mul_(self.w.get(s, dev) * s_w)
                y = contrib if y is None else y.add_(contrib)
                off += c
            y = F.silu(y.add_(self.w.get(m.bias, dev, rows=rows)),
                       inplace=True)
            if m.quant == "block":
                return y.to(self.dtype).permute(0, 3, 1, 2)
            if emit_float:
                return y
            return quantize_act(y, self.w.get(m.s_out, dev))

        y = self.conv_pieces(m, codes, piece)
        return y if m.quant == "block" or emit_float else Codes(y, m.s_out)

    def residual_int8(self, layer: Bottleneck, x: Codes) -> Codes:
        """The chain's Bottleneck: c2's f32 output plus the dequantized
        input, requantized against ``s_res``, piece by piece."""
        y = self.cbl(layer.c2, self.cbl(layer.c1, x), emit_float=True)

        def piece(yt, q):
            dev = q.device
            return quantize_act(
                yt.add_(dequantize((q, self.w.get(x.scale, dev)))),
                self.w.get(layer.s_res, dev))

        return Codes(self.map(piece, y, x.pieces), layer.s_res)

    def add(self, a, b):
        return self.map(torch.add, a, b)

    def maxpool(self, x):
        if isinstance(x, Codes):
            return Codes(self.maxpool_pieces(x.pieces), x.scale)
        return self.maxpool_pieces(x)

    def maxpool_pieces(self, x):
        return self.map(maxpool_piece, x)

    def upsample(self, x):
        if isinstance(x, Codes):
            return Codes(self.upsample_pieces(x.pieces), x.scale)
        return self.upsample_pieces(x)

    def upsample_pieces(self, x):
        return self.map(upsample_piece, x)

    def cat(self, xs):
        """The channel concat of xs; in the chain a ``Concat`` of their
        operands."""
        if self.chain:
            return Concat(p for x in xs
                          for p in (x if isinstance(x, Concat) else (x,)))
        return self.cat_pieces(xs)

    def head(self, head, feats):
        """The head over [P3, P4, P5]; in the chain their codes are first
        dequantized once, to the model's dtype, as ``YOLOv5.forward``
        does."""
        if self.chain:
            feats = [self.map(lambda q, s=f.scale: dequantize(
                (q, self.w.get(s, q.device)), self.dtype).permute(0, 3, 1, 2),
                f.pieces) for f in feats]
        return self.head_pieces(head, feats)

    def prep(self, x: torch.Tensor, device: torch.device,
             normalize: bool = False) -> torch.Tensor:
        """NHWC input rows -> the model's NCHW input on ``device``, as
        ``YOLOv5.forward`` begins: the cast (or the uint8 normalize), the
        space-to-depth stem's rearrangement, the NCHW view."""
        x = x.to(device, non_blocking=True)
        x = normalize_uint8(x, self.dtype) if normalize else x.to(self.dtype)
        if self.model.stem_s2d:
            x = space_to_depth2(x)
        return x.permute(0, 3, 1, 2)

    # -- per-piece helpers ----------------------------------------------

    def conv_piece(self, m: nn.Conv2d, t: torch.Tensor,
                   rows: Optional[Tuple[int, int]] = None,
                   padding=None) -> torch.Tensor:
        """m on one piece, with m's output channels ``rows`` (all of them
        by default), its weights cast to the piece's dtype as
        ``conv_in_dtype`` does."""
        w = self.w.get(m.weight, t.device, t.dtype, rows)
        b = (None if m.bias is None
             else self.w.get(m.bias, t.device, t.dtype, rows))
        return F.conv2d(t, w, b, m.stride,
                        m.padding if padding is None else padding)

    def buffer(self, t: torch.Tensor, device, rows=None) -> torch.Tensor:
        """A BN running buffer as f32 on ``device``: cached in inference,
        read afresh in training, where it moves between micro-batches."""
        if not self.train:
            return self.w.get(t, device, torch.float32, rows)
        v = t if rows is None else t[rows[0]:rows[1]]
        return v.to(device=device, dtype=torch.float32, non_blocking=True)

    def bn_eval_piece(self, m, t: torch.Tensor, rows=None) -> torch.Tensor:
        dev = t.device
        return F.batch_norm(t, self.buffer(m.running_mean, dev, rows),
                            self.buffer(m.running_var, dev, rows),
                            self.w.get(m.weight, dev, torch.float32, rows),
                            self.w.get(m.bias, dev, torch.float32, rows),
                            False, 0.0, BN_EPS)

    def bn_global(self, m, pieces: List[torch.Tensor], rows=None) -> list:
        """Training BatchNorm of pieces of the same channels (``rows`` of
        the BN's, all by default), each of any number of positions: the
        statistics of their union, in flax's order as in
        ``BatchNorm._sync_forward``: each piece's [sum x, sum x^2] in f32,
        their sum over the total count of positions on the master device,
        var = E[x^2] - E[x]^2 clipped at 0, the running buffers moved
        once, y = (x - mean) * (rsqrt(var + eps) * w) + b. The statistics
        stay in autograd."""
        master = m.weight.device
        xf = [t.float() for t in pieces]
        stats = None
        for x in xf:
            s = torch.cat([x.sum((0, 2, 3)), (x * x).sum((0, 2, 3))]).to(
                master)
            stats = s if stats is None else stats + s
        stats = stats / sum(t.numel() // t.shape[1] for t in pieces)
        c = stats.shape[0] // 2
        mean, mean2 = stats[:c], stats[c:]
        var = (mean2 - mean * mean).clamp(min=0.0)
        lo, hi = rows or (0, m.running_mean.shape[0])
        if m.update_stats:
            with torch.no_grad():
                m.running_mean[lo:hi].mul_(BN_DECAY).add_(
                    mean, alpha=1 - BN_DECAY)
                m.running_var[lo:hi].mul_(BN_DECAY).add_(
                    var, alpha=1 - BN_DECAY)
        mul = torch.rsqrt(var + BN_EPS) * m.weight[lo:hi].float()
        shift = m.bias[lo:hi].float()
        out = []
        for t, x in zip(pieces, xf):
            dev = t.device
            y = ((x - mean.to(dev)[:, None, None]) * mul.to(dev)[:, None, None]
                 + shift.to(dev)[:, None, None])
            out.append(y.to(t.dtype))
        return out


def batch_norm_local(t: torch.Tensor, w, b, running_mean, running_var):
    """``BatchNorm.forward``'s training arithmetic on one piece with its
    own statistics: (y, the new running mean, the new running var), the
    buffers given on t's device in f32 and left alone."""
    n = t.numel() // t.shape[1]
    mean, var = running_mean.clone(), running_var.clone()
    y = F.batch_norm(t, mean, var, w, b, True, 1 - BN_DECAY, BN_EPS)
    with torch.no_grad():
        var = running_var.mul(BN_DECAY / n).add_(var, alpha=(n - 1) / n)
    return y, mean, var


class ReplicaOps(Ops):
    """A value is a list of tensors, one a data replica, each on its own
    device. BatchNorm uses each replica's own statistics (DP's local BN);
    the running buffers move to the mean of the replicas' updates, which
    equals averaging the replicas' buffers afterwards (the update is
    linear). With one replica this is ``YOLOv5.forward`` op for op."""

    def map(self, fn, *xs):
        return [fn(*ts) for ts in zip(*xs)]

    def conv_pieces(self, m, xs, fn):
        pad = conv_geometry(m)[2]
        return [fn(list(ts), None, pad) for ts in zip(*xs)]

    def bn(self, m, x):
        if not self.train:
            return [self.bn_eval_piece(m, t) for t in x]
        out, means, vars_ = [], [], []
        master = m.running_mean.device
        for t in x:
            dev = t.device
            y, mean, var = batch_norm_local(
                t, self.w.get(m.weight, dev, torch.float32),
                self.w.get(m.bias, dev, torch.float32),
                self.buffer(m.running_mean, dev),
                self.buffer(m.running_var, dev))
            out.append(y)
            means.append(mean.to(master))
            vars_.append(var.to(master))
        if m.update_stats:
            with torch.no_grad():
                if len(x) == 1:
                    m.running_mean.copy_(means[0])
                    m.running_var.copy_(vars_[0])
                else:
                    m.running_mean.copy_(torch.stack(means).sum(0) / len(x))
                    m.running_var.copy_(torch.stack(vars_).sum(0) / len(x))
        return out

    def cat_pieces(self, xs):
        return [torch.cat(ts, 1) for ts in zip(*xs)]

    def head_pieces(self, head, feats):
        no = 5 + head.nc
        return [[head_layout(y, head.na, no) for y in self.conv(conv, f)]
                for conv, f in zip(head.out_convs, feats)]
