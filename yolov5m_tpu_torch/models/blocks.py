"""YOLOv5 building blocks as PyTorch modules (float path).

Port of ``yolov5m_tpu/models/blocks.py``. Inside the model tensors are
NCHW views in ``channels_last`` memory, which is what cuDNN's bf16
convolutions want; the public model interface stays NHWC
(``models/yolo.py``). Attribute names reproduce the reference torch
state-dict keys (``backbone.2.seq.0.c1.cbl.0.weight``, ...), so
``load_state_dict(strict=True)`` takes the weights that
``models/weights.py`` produces, and ``state_dict()`` gives back exactly
those keys.

Precision follows the JAX package: parameters may stay f32 while the
activations run in a lower dtype (bf16 for training). Each conv casts its
weights to the dtype of its input (explicit casts, no autocast), and
BatchNorm computes in f32 and returns the activations' dtype to the SiLU.

  * CBL        - conv(bias=False) + BN(eps=1e-3) + SiLU, or, with
                 ``fused=True``, conv(bias=True) + SiLU (BN folded in,
                 ``models/fuse.py``)
  * Bottleneck - 1x1 CBL -> 3x3 CBL + residual
  * C3         - CSP split/concat; neck mode replaces the residual
                 Bottlenecks with plain CBL(1x1) -> CBL(3x3) pairs
  * SPPF       - 3 chained 5x5 max pools

int8 post-training quantization (``models/quantize.py``), the JAX
package's two schemes, chosen by ``quant``:

  * "block": each CBL quantizes its float input against its calibrated
    ``s_in``, convolves int8 x int8 -> int32, and returns
    ``silu(acc * (s_in * s_w) + bias)`` in the input's dtype; the graph
    between CBLs stays float.
  * "chain": activations flow between CBLs as ``(q, s)`` pairs of int8
    codes (NHWC, contiguous) and their f32 scale; each CBL's epilogue
    requantizes its SiLU output to its calibrated ``s_out``. A concat is a
    list of parts, convolved as a split convolution (each part against its
    input-channel slice of the weights, the partial products summed in
    f32), so no concat is ever rescaled.

The int32 accumulators come from ``torch._int_mm`` (cuBLASLt on the card)
on the channels_last view: a 1x1 conv is a plain GEMM, a kxk one first
gathers its patches (``conv_int8``). ``conv_int8_plain`` is the same
convolution in float64, which is exact for int8 codes.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

# flax BatchNorm: running = BN_DECAY * running + (1 - BN_DECAY) * batch
BN_DECAY = 0.97
BN_EPS = 1e-3


def conv_in_dtype(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """conv(x) with the weights cast to x's dtype: f32 master weights run
    a bf16 convolution on bf16 activations, as flax's ``Conv(dtype=...)``
    does."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride,
                    conv.padding)


# int8 schemes of ``CBL(quant=...)``: None (float), "block", "chain"
QUANT_SCHEMES = (None, "block", "chain")
# cuBLASLt's int8 GEMM (torch._int_mm on the card) takes M > 16 rows and
# K and N multiples of 8
MM_MIN_ROWS = 17
MM_ALIGN = 8


def quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 -> symmetric int8 against a per-tensor scale:
    clip(round_half_even(x / s), -127, 127)."""
    return (x / scale).round_().clamp_(-127, 127).to(torch.int8)


def dequantize(part, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(q int8, s scalar) -> float: (q * s) in f32, then cast to dtype."""
    q, s = part
    return (q.float() * s).to(dtype)


def maxpool_int8(q: torch.Tensor, window: int = 5, pad: int = 2,
                 row_pad=None) -> torch.Tensor:
    """5x5 stride-1 max pool of NHWC int8 codes. Max is monotone, so pooling
    the codes is exact at their scale; the -128 padding never wins (each
    window holds its centre, >= -127). Separable: rows, then columns.
    row_pad: the rows' padding where it differs from the columns' (a row
    shard that brings its neighbours' rows pads none)."""
    rp = pad if row_pad is None else row_pad
    x = F.pad(q, (0, 0, pad, pad, rp, rp), value=-128)
    return x.unfold(2, window, 1).amax(-1).unfold(1, window, 1).amax(-1)


def upsample2x_codes(q: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of NHWC int8 codes: each code repeated."""
    b, h, w, c = q.shape
    return q[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(
        b, 2 * h, 2 * w, c)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def conv_int8(q: torch.Tensor, w_q: torch.Tensor, stride: int = 1,
              pad=0) -> torch.Tensor:
    """int8 NHWC codes (B, H, W, C) conv int8 OIHW weights (O, C, k, k) ->
    int32 accumulators (B, Ho, Wo, O): XLA's ``conv_general_dilated(...,
    preferred_element_type=int32)`` as one ``torch._int_mm``. A 1x1 stride-1
    conv is a GEMM on the codes as they lie; otherwise the patches are
    gathered, in (kh, kw, c) order, into one (M, K) matrix. Zero rows and
    columns pad M, K and N to what cuBLASLt takes (the stem's K of 108 to
    112), which changes no sum. pad: an int, or (rows, columns)."""
    ph, pw = (pad, pad) if isinstance(pad, int) else pad
    b, h, w, c = q.shape
    o, c_w, k, _ = w_q.shape
    if c_w != c:
        raise ValueError(f"conv_int8: {c} input channels, weights {tuple(w_q.shape)}")
    ho, wo = (h + 2 * ph - k) // stride + 1, (w + 2 * pw - k) // stride + 1
    m, kk = b * ho * wo, k * k * c
    mp, kp, n_p = max(m, MM_MIN_ROWS), _round_up(kk, MM_ALIGN), _round_up(o, MM_ALIGN)
    if k == 1 and stride == 1 and ph == pw == 0 and (mp, kp) == (m, kk):
        a = q.reshape(m, kk)
    else:
        if ph or pw:
            q = F.pad(q, (0, 0, pw, pw, ph, ph))
        win = q.unfold(1, k, stride).unfold(2, k, stride)  # (b, ho, wo, c, k, k)
        a = q.new_empty(mp, kp)
        a[:m, :kk].view(b, ho, wo, k, k, c).copy_(win.permute(0, 1, 2, 4, 5, 3))
        a[:, kk:].zero_()
        a[m:].zero_()
    wm = w_q.permute(0, 2, 3, 1).reshape(o, kk)
    if (n_p, kp) != (o, kk):
        wm = F.pad(wm, (0, kp - kk, 0, n_p - o))
    acc = torch._int_mm(a, wm.t())     # (M, K) row-major x (K, N) column-major
    if (mp, n_p) != (m, o):
        acc = acc[:m, :o].contiguous()
    return acc.view(b, ho, wo, o)


def conv_int8_plain(q: torch.Tensor, w_q: torch.Tensor, stride: int = 1,
                    pad: int = 0) -> torch.Tensor:
    """``conv_int8``'s plain version: the same convolution in float64, exact
    for int8 codes (|acc| <= K * 127^2 < 2^53)."""
    y = F.conv2d(q.permute(0, 3, 1, 2).double(), w_q.double(), None, stride,
                 pad)
    return y.permute(0, 2, 3, 1).to(torch.int32).contiguous()


class BatchNorm(nn.Module):
    """BatchNorm over the channels of NCHW input, with flax
    ``nn.BatchNorm`` semantics (momentum 0.97, eps 1e-3).

    Training normalizes with the biased batch statistics and updates
    ``running = 0.97 * running + 0.03 * batch`` with the BIASED batch
    variance, where ``nn.BatchNorm2d`` would use the unbiased one (a factor
    n/(n-1), large at P5 of a small batch). Statistics are reduced in f32
    (f32 parameters and buffers with a bf16 input); the output has the
    input's dtype. There is no ``num_batches_tracked`` buffer, so the state
    dict holds just the keys flax's tree maps to.

    group: a torch.distributed process group makes it sync-BN (flax's
    ``axis_name``, the JAX ``bn_axis``): training statistics are the
    group's mean of E[x] and E[x^2], var = E[x^2] - E[x]^2, all in f32,
    all-reduced through autograd so the gradient flows through the
    global statistics. None keeps the fused single-pass path."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        # False while a checkpointed block recomputes its forward
        self.update_stats = True
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.float(), self.bias.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean.float(),
                                self.running_var.float(), w, b, False, 0.0,
                                BN_EPS)
        if self.group is not None:
            return self._sync_forward(x, w, b)
        # One fused pass normalizes with the biased batch statistics and
        # moves copies of the running ones (the backward keeps the buffers
        # it is given), but with the unbiased variance: var = d*old +
        # (1-d)*v*n/(n-1). Then d*old/n + var*(n-1)/n = d*old + (1-d)*v.
        n = x.numel() // x.shape[1]
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, w, b, True, 1 - BN_DECAY, BN_EPS)
        if self.update_stats:
            with torch.no_grad():
                self.running_var.mul_(BN_DECAY / n).add_(var,
                                                         alpha=(n - 1) / n)
                self.running_mean.copy_(mean)
        return y

    def _sync_forward(self, x, w, b):
        """Training with the group's statistics, in flax's order: one
        all_reduce of [E[x], E[x^2]] divided by the group size, var clipped
        at 0, y = (x - mean) * (rsqrt(var + eps) * w) + b."""
        from torch.distributed import get_world_size
        from torch.distributed.nn.functional import all_reduce

        c = x.shape[1]
        xf = x.float()
        local = torch.cat([xf.mean((0, 2, 3)), (xf * xf).mean((0, 2, 3))])
        stats = all_reduce(local, group=self.group) / get_world_size(
            self.group)
        mean, mean2 = stats[:c], stats[c:]
        var = (mean2 - mean * mean).clamp(min=0.0)
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.mul_(BN_DECAY).add_(mean,
                                                      alpha=1 - BN_DECAY)
                self.running_var.mul_(BN_DECAY).add_(var, alpha=1 - BN_DECAY)
        mul = torch.rsqrt(var + BN_EPS) * w
        y = (xf - mean[:, None, None]) * mul[:, None, None] + b[:, None, None]
        return y.to(x.dtype)


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Inside: the BatchNorms of ``module`` normalize as in training but
    leave their running statistics alone. A checkpointed block's backward
    recomputes its forward, which would otherwise apply the update twice."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


class CBL(nn.Module):
    """Conv + BatchNorm + SiLU; ``cbl.0`` is the conv, ``cbl.1`` the BN
    (absent when fused).

    quant ("block" or "chain", BN folded): the int8 CBL of
    ``models/quantize.py``. Its buffers are the JAX package's int8
    parameters: ``w_q`` (int8, OIHW, per-output-channel scale ``s_w``),
    the folded ``bias``, the calibrated input scale ``s_in`` and, in the
    chain, the output scale ``s_out``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 pad: int = 0, fused: bool = False, quant=None):
        super().__init__()
        if quant not in QUANT_SCHEMES:
            raise ValueError(f"quant {quant!r}: one of {QUANT_SCHEMES}")
        if quant and not fused:
            raise ValueError("int8 PTQ runs on the BN-folded model (fused=True)")
        self.quant = quant
        if quant is None:
            layers = [nn.Conv2d(in_ch, out_ch, kernel, stride, pad,
                                bias=fused)]
            if not fused:
                layers.append(BatchNorm(out_ch))
            self.cbl = nn.Sequential(*layers)
            return
        self.stride, self.pad = stride, pad
        self.register_buffer("w_q", torch.zeros(out_ch, in_ch, kernel, kernel,
                                                dtype=torch.int8))
        self.register_buffer("s_w", torch.ones(out_ch))
        self.register_buffer("bias", torch.zeros(out_ch))
        self.register_buffer("s_in", torch.ones(()))
        if quant == "chain":
            self.register_buffer("s_out", torch.ones(()))

    def forward(self, x, emit_float: bool = False):
        if self.quant == "chain":
            return self._quant_chain_forward(x, emit_float)
        if self.quant == "block":
            return self._quant_forward(x)
        y = conv_in_dtype(self.cbl[0], x)
        if len(self.cbl) > 1:
            y = self.cbl[1](y)             # f32 statistics, x's dtype out
        return F.silu(y)

    def _quant_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Per-block int8: float NCHW in, float NCHW (x's dtype) out."""
        xq = quantize_act(x.permute(0, 2, 3, 1).float(), self.s_in)
        acc = conv_int8(xq, self.w_q, self.stride, self.pad)
        y = acc.float().mul_(self.s_in * self.s_w).add_(self.bias)
        return F.silu(y, inplace=True).to(x.dtype).permute(0, 3, 1, 2)

    def _quant_chain_forward(self, x, emit_float: bool):
        """x: a float NCHW tensor (the stem's input, quantized against
        s_in), a (q, s) pair, or a list of them (a concat, convolved as a
        split convolution). Returns (q, s_out) or, with emit_float, the f32
        NHWC activation before quantization (for a residual add)."""
        parts = x if isinstance(x, list) else [x]
        y, off = None, 0
        for p in parts:
            if isinstance(p, tuple):
                q, s = p
            else:
                q, s = quantize_act(p.permute(0, 2, 3, 1).float(),
                                    self.s_in), self.s_in
            c = q.shape[-1]
            acc = conv_int8(q, self.w_q[:, off:off + c], self.stride, self.pad)
            contrib = acc.float().mul_(s * self.s_w)
            y = contrib if y is None else y.add_(contrib)
            off += c
        if off != self.w_q.shape[1]:
            raise ValueError(f"{off} input channels in the parts, weights "
                             f"{tuple(self.w_q.shape)}")
        y = F.silu(y.add_(self.bias), inplace=True)
        if emit_float:
            return y
        return quantize_act(y, self.s_out), self.s_out


class Bottleneck(nn.Module):
    """Residual 1x1 -> 3x3 block. In the int8 chain the residual add is in
    f32 (c2 emits its float activation), then one requantization against
    the calibrated post-sum scale ``s_res``."""

    def __init__(self, in_ch: int, out_ch: int, width: float = 1.0,
                 fused: bool = False, quant=None):
        super().__init__()
        c_ = int(width * in_ch)
        self.c1 = CBL(in_ch, c_, 1, 1, 0, fused, quant)
        self.c2 = CBL(c_, out_ch, 3, 1, 1, fused, quant)
        self.chain = quant == "chain"
        if self.chain:
            self.register_buffer("s_res", torch.ones(()))

    def forward(self, x):
        if not self.chain:
            return self.c2(self.c1(x)) + x
        y = self.c2(self.c1(x), emit_float=True)
        return quantize_act(y.add_(dequantize(x)), self.s_res), self.s_res


class C3(nn.Module):
    """CSP bottleneck stack. Concat order is (main branch, skip branch); in
    the int8 chain the concat is c_out's split convolution."""

    def __init__(self, in_ch: int, out_ch: int, width: float = 1.0,
                 depth: int = 1, backbone: bool = True, fused: bool = False,
                 quant=None):
        super().__init__()
        c_ = int(width * in_ch)
        self.c1 = CBL(in_ch, c_, 1, 1, 0, fused, quant)
        if backbone:
            seq = [Bottleneck(c_, c_, 1.0, fused, quant) for _ in range(depth)]
        else:
            seq = [nn.Sequential(CBL(c_, c_, 1, 1, 0, fused, quant),
                                 CBL(c_, c_, 3, 1, 1, fused, quant))
                   for _ in range(depth)]
        self.seq = nn.Sequential(*seq)
        self.c_skipped = CBL(in_ch, c_, 1, 1, 0, fused, quant)
        self.c_out = CBL(2 * c_, out_ch, 1, 1, 0, fused, quant)
        self.chain = quant == "chain"

    def forward(self, x):
        y = self.seq(self.c1(x))
        skip = self.c_skipped(x)
        if self.chain:
            return self.c_out([y, skip])
        return self.c_out(torch.cat([y, skip], dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling - fast. In the int8 chain the pools run on
    the codes and the 4-way concat is c_out's split convolution."""

    def __init__(self, in_ch: int, out_ch: int, fused: bool = False,
                 quant=None):
        super().__init__()
        c_ = in_ch // 2
        self.c1 = CBL(in_ch, c_, 1, 1, 0, fused, quant)
        self.c_out = CBL(4 * c_, out_ch, 1, 1, 0, fused, quant)
        self.chain = quant == "chain"

    def forward(self, x):
        x = self.c1(x)
        if self.chain:
            q, s = x
            p1 = maxpool_int8(q)
            p2 = maxpool_int8(p1)
            p3 = maxpool_int8(p2)
            return self.c_out([(q, s), (p1, s), (p2, s), (p3, s)])
        p1 = F.max_pool2d(x, 5, 1, 2)
        p2 = F.max_pool2d(p1, 5, 1, 2)
        p3 = F.max_pool2d(p2, 5, 1, 2)
        return self.c_out(torch.cat([x, p1, p2, p3], dim=1))


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Exact nearest-neighbour 2x upsample of an NCHW tensor (the JAX
    twin repeats rows and columns of an NHWC array; same values)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
