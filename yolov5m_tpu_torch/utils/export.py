"""Model export: port of ``yolov5m_tpu/utils/export.py``.

JAX serializes the jitted forward as a StableHLO artifact
(``export_stablehlo``); the port saves a ``torch.export`` program with
``torch.export.save``, which ``load_program`` (or ``torch.export.load``)
reads back anywhere PyTorch runs. The input is f32 NHWC (bs, size, size,
3) in [0, 1], as JAX's is. Export the model in f32 with contiguous
weights, as the export CLI builds it; the program runs on the device the
model is on.

With postprocess the program also holds ``decode_predictions`` and
``batched_nms(..., backend="torch")``: fixed-shape (bs, 300, 6) detections
and their valid mask. JAX pins its XLA NMS in the artifact so that it runs
on any StableHLO consumer; the port pins its plain NMS for the same
reason (the CUDA kernel is a ctypes call, which no trace can hold).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch
from torch import nn

from yolov5m_tpu_torch.models.yolo import normalized_anchors
from yolov5m_tpu_torch.ops.decode import decode_predictions
from yolov5m_tpu_torch.ops.nms import batched_nms


class _Forward(nn.Module):
    """The model's raw outputs as a tuple."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, image: torch.Tensor):
        return tuple(self.model(image))


class _WithPostprocess(nn.Module):
    """Model, decode and the plain NMS: (out (bs, 300, 6), valid)."""

    def __init__(self, model: nn.Module, anchors: np.ndarray, conf: float,
                 iou: float):
        super().__init__()
        self.model, self.conf, self.iou = model, conf, iou
        self.register_buffer("anchors", torch.from_numpy(anchors))

    def forward(self, image: torch.Tensor):
        rows = decode_predictions(self.model(image), self.anchors)
        return batched_nms(rows, self.iou, self.conf, 300, 1024,
                           backend="torch")


def export_program(model: nn.Module, path: str,
                   input_shape: Tuple[int, int, int, int] = (1, 640, 640, 3),
                   with_postprocess: bool = False, conf: float = 0.25,
                   iou: float = 0.45, anchors_px=None) -> str:
    """Save the model's forward (in eval mode) as a torch.export program.

    with_postprocess: also bake in decode and NMS. anchors_px: (nl, na, 2)
    pixel anchors to bake in (an autoanchor refit); default COCO anchors.
    Returns the written path."""
    anchors = normalized_anchors() if anchors_px is None else \
        normalized_anchors(anchors=np.asarray(anchors_px, np.float32))
    model = model.eval()
    module = (_WithPostprocess(model, anchors, conf, iou) if with_postprocess
              else _Forward(model))
    device = next(model.parameters()).device
    example = torch.zeros(input_shape, dtype=torch.float32, device=device)
    with torch.no_grad():
        program = torch.export.export(module.to(device), (example,))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path)
    return path


def load_program(path: str):
    """The saved program as a callable module."""
    return torch.export.load(path).module()


def count_parameters(model: nn.Module) -> int:
    """Trainable parameter count (JAX: the leaves of variables["params"])."""
    return int(sum(p.numel() for p in model.parameters()))


def model_size_mb(model: nn.Module) -> float:
    """Parameters and buffers (the BN statistics) in MB, as JAX counts its
    variables."""
    tensors = list(model.parameters()) + list(model.buffers())
    return sum(t.numel() * t.element_size() for t in tensors) / 1024 ** 2
