"""YOLOv5 building blocks as PyTorch modules (float path).

Port of ``yolov5m_tpu/models/blocks.py``. Inside the model tensors are
NCHW views in ``channels_last`` memory, which is what cuDNN's bf16
convolutions want; the public model interface stays NHWC
(``models/yolo.py``). Attribute names reproduce the reference torch
state-dict keys (``backbone.2.seq.0.c1.cbl.0.weight``, ...), so
``load_state_dict(strict=True)`` takes the weights that
``models/weights.py`` produces.

  * CBL        - conv(bias=False) + BN(eps=1e-3) + SiLU, or, with
                 ``fused=True``, conv(bias=True) + SiLU (BN folded in,
                 ``models/fuse.py``)
  * Bottleneck - 1x1 CBL -> 3x3 CBL + residual
  * C3         - CSP split/concat; neck mode replaces the residual
                 Bottlenecks with plain CBL(1x1) -> CBL(3x3) pairs
  * SPPF       - 3 chained 5x5 max pools
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# torch BatchNorm2d momentum 0.03 is flax decay 0.97
BN_MOMENTUM = 0.03
BN_EPS = 1e-3


class CBL(nn.Module):
    """Conv + BatchNorm + SiLU; ``cbl.0`` is the conv, ``cbl.1`` the BN
    (absent when fused)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 pad: int = 0, fused: bool = False):
        super().__init__()
        layers = [nn.Conv2d(in_ch, out_ch, kernel, stride, pad, bias=fused)]
        if not fused:
            layers.append(nn.BatchNorm2d(out_ch, eps=BN_EPS,
                                         momentum=BN_MOMENTUM))
        layers.append(nn.SiLU())
        self.cbl = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cbl(x)


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
