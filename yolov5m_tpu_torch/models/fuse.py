"""Inference-time BatchNorm folding on a torch-layout state dict.

Port of ``yolov5m_tpu/models/fuse.py:fold_batchnorm``:

  y = scale * (conv(x) - mean) / sqrt(var + eps) + bias
    = conv'(x) + b'    with  conv' = conv * s,  s = scale/sqrt(var+eps),
                             b' = bias - mean * s

The per-channel scale is computed in float64 and cast to float32, as the
JAX host fold does, so the folded weights are bit-equal to its output.
"""

from __future__ import annotations

from typing import Dict

import torch

from yolov5m_tpu_torch.models.blocks import BN_EPS


def fold_batchnorm(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Unfused state dict (``YOLOv5(fused=False)`` keys) -> state dict for
    ``YOLOv5(fused=True)``: each ``cbl.0`` conv gains a bias and the
    ``cbl.1`` BatchNorm entries are dropped. Head convs copy through."""
    fused = {}
    for key, value in state_dict.items():
        if ".cbl.1." in key:
            continue                                   # BN: folded away
        if key.endswith(".cbl.0.weight"):
            bn = key[:-len("0.weight")] + "1."
            scale, bias = state_dict[bn + "weight"], state_dict[bn + "bias"]
            mean, var = state_dict[bn + "running_mean"], state_dict[bn + "running_var"]
            s = (scale.double() / torch.sqrt(var.double() + BN_EPS)).float()
            fused[key] = value * s.view(-1, 1, 1, 1)        # OIHW: O first
            fused[key[:-len("weight")] + "bias"] = bias - mean * s
        else:
            fused[key] = value
    return fused
