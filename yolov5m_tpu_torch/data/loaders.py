"""Loader factory for disk datasets and the move of a batch to the device.

Port of ``yolov5m_tpu/data/loaders.py`` (``default_multiscale_sizes``,
``get_loaders``), plus ``to_device``, which the trainer's loop and the
evaluator use.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from yolov5m_tpu_torch.data.augment import TrainAugment
from yolov5m_tpu_torch.data.dataset import BatchLoader, DetectionDataset


def default_multiscale_sizes(image_size: int):
    """Default multi-scale buckets for non-rect training: {0.8, 0.9, 1.0}x
    image_size snapped to multiples of 32, [512, 576, 640] at 640. None when
    the buckets collapse to one size (tiny images)."""
    sizes = sorted({max(32, round(f * image_size / 32) * 32)
                    for f in (0.8, 0.9, 1.0)})
    return sizes if len(sizes) > 1 else None


def get_loaders(db_root_dir: str, batch_size: int,
                rect_training: bool = False, box_format: str = "coco",
                augment: bool = True, max_boxes: int = 120,
                default_size: int = 640, seed: int = 0,
                multi_scale_sizes=None, num_workers: int = 0,
                mosaic_p: float = 0.0, hsv: bool = False,
                device_augment: bool = False, rank: int = 0,
                world_size: int = 1) -> Tuple[BatchLoader, BatchLoader]:
    """Train and val BatchLoaders over {root}/images|labels/{train,val}.

    device_augment: color jitter and flips run on the device
    (ops/augment_device.py), so the host TrainAugment keeps rotate, the
    batch-parity transpose, blur, CLAHE, posterize and channel shuffle
    only, and no batch is augmented twice. HSV moves the same way through ``hsv`` (the caller
    passes hsv=False when the device runs it).

    rank, world_size: the train loader builds this rank's rows of each
    global batch of ``batch_size`` (BatchLoader); the val loader stays
    whole, for the rank that evaluates."""
    train_ds = DetectionDataset(
        root_directory=db_root_dir, train=True, rect_training=rect_training,
        default_size=default_size, bs=batch_size, bboxes_format=box_format,
        max_boxes=max_boxes)
    val_ds = DetectionDataset(
        root_directory=db_root_dir, train=False, rect_training=rect_training,
        default_size=default_size, bs=batch_size, bboxes_format=box_format,
        max_boxes=max_boxes)

    host_aug = None
    if augment:
        host_aug = TrainAugment(seed=seed, hflip_p=0.0, vflip_p=0.0,
                                color_jitter_p=0.0) \
            if device_augment else TrainAugment(seed=seed)
    train_loader = BatchLoader(
        train_ds, batch_size, shuffle=not rect_training, augment=host_aug,
        seed=seed, drop_last=True, size_buckets=multi_scale_sizes,
        num_workers=num_workers, mosaic_p=mosaic_p, hsv=hsv, rank=rank,
        world_size=world_size)
    val_loader = BatchLoader(val_ds, batch_size, shuffle=False, augment=None,
                             seed=seed, drop_last=False,
                             num_workers=num_workers)
    return train_loader, val_loader


def to_device(value, device: torch.device) -> torch.Tensor:
    """A batch array (numpy or tensor) as a tensor on ``device``, values
    unchanged. A host array bound for the card is copied into pinned
    memory first and sent with non_blocking, so the copy overlaps the work
    already queued; the caching host allocator keeps the pinned block
    until the copy is done."""
    t = torch.as_tensor(value) if isinstance(value, np.ndarray) else value
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
