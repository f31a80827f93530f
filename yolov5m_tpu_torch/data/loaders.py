"""Loader helpers: own copy of ``default_multiscale_sizes`` from
``yolov5m_tpu/data/loaders.py`` (the disk loaders are not ported yet)."""

from __future__ import annotations


def default_multiscale_sizes(image_size: int):
    """Default multi-scale buckets for non-rect training: {0.8, 0.9, 1.0}x
    image_size snapped to multiples of 32, [512, 576, 640] at 640. None when
    the buckets collapse to one size (tiny images)."""
    sizes = sorted({max(32, round(f * image_size / 32) * 32)
                    for f in (0.8, 0.9, 1.0)})
    return sizes if len(sizes) > 1 else None
