"""YOLOv5m graph: CSP backbone + PANet neck + 3-scale anchor head.

Port of ``yolov5m_tpu/models/yolo.py`` (float path with remat; the
space-to-depth stem and int8 wait). The model takes NHWC ``(bs, H, W, 3)`` like the JAX
model; ``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor already is an
NCHW view in ``channels_last`` memory, so no copy is made on the way in.
Each scale's output is ``(bs, na, ny, nx, 5+nc)`` with the anchor-major
channel grouping ``c = a*no + o`` of the reference head.
"""

from __future__ import annotations

import contextlib
import functools
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from yolov5m_tpu_torch.config import ANCHORS, STRIDES
from yolov5m_tpu_torch.models.blocks import (C3, CBL, SPPF, BatchNorm,
                                             conv_in_dtype,
                                             frozen_running_stats,
                                             upsample2x_nearest)

REMAT_SCOPES = ("c3", "all")


def normalized_anchors(anchors=ANCHORS, strides=STRIDES) -> np.ndarray:
    """(nl, na, 2) anchors divided by their scale stride."""
    a = np.asarray(anchors, np.float32)
    return a / np.asarray(strides, np.float32)[:, None, None]


class Head(nn.Module):
    """Per-scale 1x1 output convs + anchor-major reshape."""

    def __init__(self, in_channels: Sequence[int], nc: int, na: int = 3):
        super().__init__()
        self.nc, self.na = nc, na
        self.out_convs = nn.ModuleList(
            nn.Conv2d(c, (5 + nc) * na, 1) for c in in_channels)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        no = 5 + self.nc
        outs = []
        for conv, f in zip(self.out_convs, feats):
            y = conv_in_dtype(conv, f).permute(0, 2, 3, 1)   # NHWC view
            bs, ny, nx, _ = y.shape
            # channel c = a*no + o, as the reference's view(bs, na, no, ...)
            outs.append(y.reshape(bs, ny, nx, self.na, no)
                        .permute(0, 3, 1, 2, 4))
        return outs


# YOLOv5 family presets: (first_out, depth_mult).
FAMILY = {
    "n": (16, 0.33),
    "s": (32, 0.33),
    "m": (48, 0.67),
    "l": (64, 1.00),
    "x": (80, 1.33),
}


def _scaled_depth(base: int, depth_mult: float) -> int:
    return max(round(base * depth_mult), 1)


class YOLOv5(nn.Module):
    """YOLOv5 detector parameterized by width (first_out) and depth
    (depth_mult); defaults are YOLOv5m. ``fused=True`` builds the
    inference graph with BatchNorm folded into the convs.

    compute_dtype: the activations' dtype (the input is cast to it and
    every conv runs in it); None means the weights' dtype. Training keeps
    f32 weights and passes torch.bfloat16, the JAX package's policy.

    remat: under autograd, the C3 stacks (remat_scope "c3") or every
    backbone and neck block (CBLs and the SPPF too, "all") run under
    ``torch.utils.checkpoint``: their inner activations are dropped after
    the forward and recomputed in the backward, trading compute for
    memory. Parameters and results are those without remat; the
    recompute leaves the BatchNorm running statistics alone.

    bn_group: a torch.distributed process group makes every BatchNorm
    sync-BN over it in training (the JAX ``bn_axis``); None keeps local
    statistics."""

    def __init__(self, first_out: int = 48, nc: int = 80,
                 depth_mult: float = 0.67, fused: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 remat: bool = False, remat_scope: str = "c3",
                 bn_group=None):
        super().__init__()
        if remat_scope not in REMAT_SCOPES:
            raise ValueError(f"remat_scope {remat_scope!r}: one of "
                             f"{REMAT_SCOPES}")
        fo, fu = first_out, fused
        self.first_out, self.nc, self.fused = first_out, nc, fused
        self.depth_mult, self.compute_dtype = depth_mult, compute_dtype
        self.remat, self.remat_scope = remat, remat_scope
        d3 = _scaled_depth(3, depth_mult)   # m: 2
        d6 = _scaled_depth(6, depth_mult)   # m: 4
        d9 = _scaled_depth(9, depth_mult)   # m: 6
        # Backbone: taps after idx 4 (P3-level) and 6 (P4-level).
        self.backbone = nn.ModuleList([
            CBL(3, fo, 6, 2, 2, fu),
            CBL(fo, fo * 2, 3, 2, 1, fu),
            C3(fo * 2, fo * 2, 0.5, d3, True, fu),
            CBL(fo * 2, fo * 4, 3, 2, 1, fu),
            C3(fo * 4, fo * 4, 0.5, d6, True, fu),
            CBL(fo * 4, fo * 8, 3, 2, 1, fu),
            C3(fo * 8, fo * 8, 0.5, d9, True, fu),
            CBL(fo * 8, fo * 16, 3, 2, 1, fu),
            C3(fo * 16, fo * 16, 0.5, d3, True, fu),
            SPPF(fo * 16, fo * 16, fu),
        ])
        # Neck: FPN-up + PAN-down. Input channels count the concats.
        self.neck = nn.ModuleList([
            CBL(fo * 16, fo * 8, 1, 1, 0, fu),
            C3(fo * 16, fo * 8, 0.25, d3, False, fu),
            CBL(fo * 8, fo * 4, 1, 1, 0, fu),
            C3(fo * 8, fo * 4, 0.25, d3, False, fu),
            CBL(fo * 4, fo * 4, 3, 2, 1, fu),
            C3(fo * 8, fo * 8, 0.5, d3, False, fu),
            CBL(fo * 8, fo * 8, 3, 2, 1, fu),
            C3(fo * 16, fo * 16, 0.5, d3, False, fu),
        ])
        self.head = Head((fo * 4, fo * 8, fo * 16), nc)
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.group = bn_group

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: (bs, H, W, 3) NHWC, H and W divisible by 32, any float dtype
        (cast to the weights' dtype). Returns [P3, P4, P5] raw logits,
        each (bs, 3, H/S, W/S, 5+nc)."""
        if x.shape[1] % 32 or x.shape[2] % 32:
            raise ValueError(f"H and W must be divisible by 32, got {tuple(x.shape)}")
        dtype = self.compute_dtype or self.backbone[0].cbl[0].weight.dtype
        x = x.permute(0, 3, 1, 2).to(dtype)

        taps = []
        for idx, layer in enumerate(self.backbone):
            x = self._block(layer, x)
            if idx in (4, 6):
                taps.append(x)

        feats, stash = [], []
        for idx, layer in enumerate(self.neck):
            x = self._block(layer, x)
            if idx in (0, 2):
                stash.append(x)
                x = torch.cat([upsample2x_nearest(x), taps.pop()], dim=1)
            elif idx in (4, 6):
                x = torch.cat([x, stash.pop()], dim=1)
            elif idx > 2:
                feats.append(x)
        return self.head(feats)

    def _block(self, layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """layer(x), checkpointed where remat asks for it."""
        if not (self.remat and torch.is_grad_enabled()
                and (self.remat_scope == "all" or isinstance(layer, C3))):
            return layer(x)
        # the blocks draw no random numbers: no RNG state to keep
        return checkpoint(layer, x, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=functools.partial(_recompute_context,
                                                       layer))


def _recompute_context(layer: nn.Module):
    """checkpoint's (forward, recompute) contexts for ``layer``."""
    return contextlib.nullcontext(), frozen_running_stats(layer)


def from_family(variant: str, nc: int = 80, fused: bool = False) -> YOLOv5:
    """Build a YOLOv5 family member by name: n/s/m/l/x (see FAMILY)."""
    fo, dm = FAMILY[variant]
    return YOLOv5(first_out=fo, depth_mult=dm, nc=nc, fused=fused)
