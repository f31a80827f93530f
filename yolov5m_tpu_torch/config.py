"""Configuration for the PyTorch/CUDA port of the YOLOv5m framework.

An own copy of ``yolov5m_tpu/config.py`` (the port imports nothing of the
JAX package): the same frozen dataclass, default hyperparameters, anchors,
strides and class-name lists, so both packages describe one model.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

# Anchor priors in pixels at 640x640, 3 per scale (P3/8, P4/16, P5/32).
ANCHORS: Tuple[Tuple[Tuple[int, int], ...], ...] = (
    ((10, 13), (16, 30), (33, 23)),      # P3/8
    ((30, 61), (62, 45), (59, 119)),     # P4/16
    ((116, 90), (156, 198), (373, 326)),  # P5/32
)

STRIDES: Tuple[int, int, int] = (8, 16, 32)

FLIR_LABELS = ("car", "person")

COCO_LABELS = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
)


@dataclasses.dataclass(frozen=True)
class Config:
    """Hyperparameters, with the JAX package's defaults."""

    # Model
    first_out: int = 48                  # YOLOv5m width
    nc: int = 80                         # number of classes
    image_size: int = 640

    # Optimizer
    learning_rate: float = 5e-4
    weight_decay: float = 5e-4
    max_grad_norm: float = 10.0
    nominal_batch_size: int = 64

    # Loss weighting
    cls_pw: float = 1.0
    obj_pw: float = 1.0
    anchor_t: float = 4.0
    ignore_iou_thresh: float = 0.5
    iou_type: str = "giou"
    label_smoothing: float = 0.0
    focal_gamma: float = 0.0

    # Postprocess / eval thresholds
    conf_threshold: float = 0.01
    nms_iou_thresh: float = 0.6
    map_iou_thresh: float = 0.5

    # Fixed-shape capacities
    max_boxes_per_image: int = 120       # padded label capacity
    pre_nms_topk: int = 1024             # candidates entering NMS per image
    max_detections: int = 300

    def topk_for_conf(self, conf_threshold: float) -> int:
        """NMS candidate capacity scaled to the confidence gate: at the
        serving gate (conf >= 0.25) few candidates pass, so K=512 loses
        nothing; at the eval gate (0.01) thousands pass and the full
        pre_nms_topk preserves recall. max_detections=300 stays below
        either K."""
        if conf_threshold >= 0.25:
            return min(self.pre_nms_topk, 512)
        return self.pre_nms_topk

    # Precision policy
    compute_dtype: str = "bfloat16"      # params stay float32

    # Training schedule
    epochs: int = 273
    batch_size: int = 16
    lr_schedule: str = "constant"        # constant | cosine
    warmup_steps: int = 0
    lr_final: float = 0.01
    guard_nonfinite: bool = False
    flat_optimizer: bool = False

    @property
    def num_scales(self) -> int:
        return len(ANCHORS)

    @property
    def anchors_per_scale(self) -> int:
        return len(ANCHORS[0])

    @property
    def head_channels(self) -> Tuple[int, int, int]:
        return (self.first_out * 4, self.first_out * 8, self.first_out * 16)


def require_device(device="cuda") -> torch.device:
    """The device an entry point runs on. The default is the card; the CPU
    is used only when the caller asks for it, and a missing card raises
    rather than falling back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev
