"""YOLOv5m graph: CSP backbone + PANet neck + 3-scale anchor head.

Port of ``yolov5m_tpu/models/yolo.py``: the float path with remat, the
space-to-depth stem (``models/s2d.py``) and the two int8 schemes
(``models/quantize.py``). The model takes NHWC ``(bs, H, W, 3)`` like the
JAX model; ``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor already is
an NCHW view in ``channels_last`` memory, so no copy is made on the way in.
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
                                             conv_in_dtype, dequantize,
                                             frozen_running_stats,
                                             upsample2x_codes,
                                             upsample2x_nearest)
from yolov5m_tpu_torch.models.s2d import space_to_depth2

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
    statistics.

    stem_s2d: the space-to-depth stem, ``CBL(12, fo, 3, 1, 1)`` on the
    2x2 space-to-depth input (weights from ``s2d.stem_weights_to_s2d``).

    quant: int8 PTQ inference on the BN-folded graph (``models/quantize.py``
    builds it): "chain" (the JAX ``quant=True, quant_chain=True``) or
    "block" (``quant=True``). The head's 1x1 convs stay float. Keep the
    weights f32 and set compute_dtype: ``.to(dtype)`` would also cast the
    int8 model's scales."""

    def __init__(self, first_out: int = 48, nc: int = 80,
                 depth_mult: float = 0.67, fused: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 remat: bool = False, remat_scope: str = "c3",
                 bn_group=None, stem_s2d: bool = False, quant=None):
        super().__init__()
        if remat_scope not in REMAT_SCOPES:
            raise ValueError(f"remat_scope {remat_scope!r}: one of "
                             f"{REMAT_SCOPES}")
        fo, fu, q = first_out, fused, quant
        self.first_out, self.nc, self.fused = first_out, nc, fused
        self.depth_mult, self.compute_dtype = depth_mult, compute_dtype
        self.remat, self.remat_scope = remat, remat_scope
        self.stem_s2d, self.quant = stem_s2d, quant
        d3 = _scaled_depth(3, depth_mult)   # m: 2
        d6 = _scaled_depth(6, depth_mult)   # m: 4
        d9 = _scaled_depth(9, depth_mult)   # m: 6
        # Backbone: taps after idx 4 (P3-level) and 6 (P4-level).
        self.backbone = nn.ModuleList([
            (CBL(12, fo, 3, 1, 1, fu, q) if stem_s2d
             else CBL(3, fo, 6, 2, 2, fu, q)),
            CBL(fo, fo * 2, 3, 2, 1, fu, q),
            C3(fo * 2, fo * 2, 0.5, d3, True, fu, q),
            CBL(fo * 2, fo * 4, 3, 2, 1, fu, q),
            C3(fo * 4, fo * 4, 0.5, d6, True, fu, q),
            CBL(fo * 4, fo * 8, 3, 2, 1, fu, q),
            C3(fo * 8, fo * 8, 0.5, d9, True, fu, q),
            CBL(fo * 8, fo * 16, 3, 2, 1, fu, q),
            C3(fo * 16, fo * 16, 0.5, d3, True, fu, q),
            SPPF(fo * 16, fo * 16, fu, q),
        ])
        # Neck: FPN-up + PAN-down. Input channels count the concats.
        self.neck = nn.ModuleList([
            CBL(fo * 16, fo * 8, 1, 1, 0, fu, q),
            C3(fo * 16, fo * 8, 0.25, d3, False, fu, q),
            CBL(fo * 8, fo * 4, 1, 1, 0, fu, q),
            C3(fo * 8, fo * 4, 0.25, d3, False, fu, q),
            CBL(fo * 4, fo * 4, 3, 2, 1, fu, q),
            C3(fo * 8, fo * 8, 0.5, d3, False, fu, q),
            CBL(fo * 8, fo * 8, 3, 2, 1, fu, q),
            C3(fo * 16, fo * 16, 0.5, d3, False, fu, q),
        ])
        self.head = Head((fo * 4, fo * 8, fo * 16), nc)
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.group = bn_group

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: (bs, H, W, 3) NHWC, H and W divisible by 32, any float dtype
        (cast to the compute dtype, or else the weights' dtype). Returns
        [P3, P4, P5] raw logits, each (bs, 3, H/S, W/S, 5+nc)."""
        if x.shape[1] % 32 or x.shape[2] % 32:
            raise ValueError(f"H and W must be divisible by 32, got {tuple(x.shape)}")
        dtype = self.compute_dtype or self.head.out_convs[0].weight.dtype
        # cast, then s2d: in bf16 the cast decides the stem's int8 codes
        x = x.to(dtype)
        if self.stem_s2d:
            x = space_to_depth2(x)
        x = x.permute(0, 3, 1, 2)
        chain = self.quant == "chain"

        taps = []
        for idx, layer in enumerate(self.backbone):
            x = self._block(layer, x)
            if idx in (4, 6):
                taps.append(x)

        # in the int8 chain a concat stays a list of (q, s) parts, and the
        # upsample repeats the codes
        feats, stash = [], []
        for idx, layer in enumerate(self.neck):
            x = self._block(layer, x)
            if idx in (0, 2):
                stash.append(x)
                if chain:
                    x = [(upsample2x_codes(x[0]), x[1]), taps.pop()]
                else:
                    x = torch.cat([upsample2x_nearest(x), taps.pop()], dim=1)
            elif idx in (4, 6):
                x = [x, stash.pop()] if chain else torch.cat(
                    [x, stash.pop()], dim=1)
            elif idx > 2:
                feats.append(x)
        if chain:       # the head's inputs, dequantized once
            feats = [dequantize(f, dtype).permute(0, 3, 1, 2) for f in feats]
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
