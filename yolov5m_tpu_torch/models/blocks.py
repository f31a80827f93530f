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
    (absent when fused)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 pad: int = 0, fused: bool = False):
        super().__init__()
        layers = [nn.Conv2d(in_ch, out_ch, kernel, stride, pad, bias=fused)]
        if not fused:
            layers.append(BatchNorm(out_ch))
        self.cbl = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_in_dtype(self.cbl[0], x)
        if len(self.cbl) > 1:
            y = self.cbl[1](y)             # f32 statistics, x's dtype out
        return F.silu(y)


class Bottleneck(nn.Module):
    """Residual 1x1 -> 3x3 block."""

    def __init__(self, in_ch: int, out_ch: int, width: float = 1.0,
                 fused: bool = False):
        super().__init__()
        c_ = int(width * in_ch)
        self.c1 = CBL(in_ch, c_, 1, 1, 0, fused)
        self.c2 = CBL(c_, out_ch, 3, 1, 1, fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c2(self.c1(x)) + x


class C3(nn.Module):
    """CSP bottleneck stack. Concat order is (main branch, skip branch)."""

    def __init__(self, in_ch: int, out_ch: int, width: float = 1.0,
                 depth: int = 1, backbone: bool = True, fused: bool = False):
        super().__init__()
        c_ = int(width * in_ch)
        self.c1 = CBL(in_ch, c_, 1, 1, 0, fused)
        if backbone:
            seq = [Bottleneck(c_, c_, 1.0, fused) for _ in range(depth)]
        else:
            seq = [nn.Sequential(CBL(c_, c_, 1, 1, 0, fused),
                                 CBL(c_, c_, 3, 1, 1, fused))
                   for _ in range(depth)]
        self.seq = nn.Sequential(*seq)
        self.c_skipped = CBL(in_ch, c_, 1, 1, 0, fused)
        self.c_out = CBL(2 * c_, out_ch, 1, 1, 0, fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.seq(self.c1(x))
        return self.c_out(torch.cat([y, self.c_skipped(x)], dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling - fast."""

    def __init__(self, in_ch: int, out_ch: int, fused: bool = False):
        super().__init__()
        c_ = in_ch // 2
        self.c1 = CBL(in_ch, c_, 1, 1, 0, fused)
        self.c_out = CBL(4 * c_, out_ch, 1, 1, 0, fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.c1(x)
        p1 = F.max_pool2d(x, 5, 1, 2)
        p2 = F.max_pool2d(p1, 5, 1, 2)
        p3 = F.max_pool2d(p2, 5, 1, 2)
        return self.c_out(torch.cat([x, p1, p2, p3], dim=1))


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Exact nearest-neighbour 2x upsample of an NCHW tensor (the JAX
    twin repeats rows and columns of an NHWC array; same values)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
