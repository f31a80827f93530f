"""Prediction images: boxes drawn on one image, and GT-vs-prediction epoch
dumps under SAVED_IMAGES/{run}/EPOCH_{n}/image_{i}.png.

Port of ``yolov5m_tpu/utils/plotting.py``. matplotlib (headless, Agg) is
imported when a figure is drawn, never when this module is imported; the
CLIs call ``require_matplotlib`` before any work, so a run that asks for
images on a machine without matplotlib stops at once instead of after an
epoch.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Sequence

import numpy as np

from yolov5m_tpu_torch.config import COCO_LABELS


def require_matplotlib(what: str) -> None:
    """Raise SystemExit naming matplotlib when it is not installed."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        raise SystemExit(f"{what} needs matplotlib, which is not installed")


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def draw_boxes(ax, image: np.ndarray, rows: np.ndarray,
               labels: Sequence[str], with_conf: bool = True) -> None:
    """rows: (n, 6) (class, conf, x1, y1, x2, y2) in pixels."""
    from matplotlib import patches

    cmap = _pyplot().get_cmap("tab20b")
    colors = [cmap(i) for i in np.linspace(0, 1, max(len(labels), 1))]
    ax.imshow(np.clip(image, 0, 1))
    h, w = image.shape[:2]
    for row in rows:
        cls = int(row[0])
        x1 = float(np.clip(row[2], 0, w))
        y1 = float(np.clip(row[3], 0, h))
        x2 = float(np.clip(row[4], 0, w))
        y2 = float(np.clip(row[5], 0, h))
        color = colors[cls % len(colors)]
        ax.add_patch(patches.Rectangle((x1, y1), x2 - x1, y2 - y1,
                                       linewidth=1.5, edgecolor=color,
                                       facecolor="none"))
        text = labels[cls] if cls < len(labels) else str(cls)
        if with_conf:
            text = f"{text}: {row[1]:.2f}"
        ax.text(x1, y1, text, color="white", verticalalignment="top",
                bbox={"color": color, "pad": 0}, fontsize="xx-small")


def plot_image(image: np.ndarray, rows: np.ndarray,
               labels: Sequence[str] = COCO_LABELS,
               save_path: Optional[str] = None) -> None:
    """One image in [0, 1] with its detections, saved to ``save_path``
    (shown when None)."""
    plt = _pyplot()
    fig, ax = plt.subplots(1)
    draw_boxes(ax, image, rows, labels)
    if save_path:
        fig.savefig(save_path, dpi=200, bbox_inches="tight")
        plt.close(fig)
    else:
        plt.show()


def save_prediction_images(images: np.ndarray,
                           pred_rows: Iterable[np.ndarray],
                           gt_rows: Iterable[np.ndarray], folder: str,
                           filename: str, epoch: int,
                           labels: Sequence[str] = COCO_LABELS,
                           num_images: int = 5) -> int:
    """Side-by-side GT and prediction images in
    {folder}/{filename}/EPOCH_{epoch}/image_{i}.png. Returns the number of
    files written."""
    plt = _pyplot()
    path = os.path.join(folder, filename, f"EPOCH_{epoch}")
    os.makedirs(path, exist_ok=True)
    written = 0
    for idx, (img, pr, gt) in enumerate(zip(images, pred_rows, gt_rows)):
        if idx >= num_images:
            break
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 5))
        ax1.set_title("Ground Truth bboxes")
        ax2.set_title("Predicted bboxes")
        draw_boxes(ax1, img, gt, labels, with_conf=False)
        draw_boxes(ax2, img, pr, labels)
        fig.savefig(os.path.join(path, f"image_{idx}.png"), dpi=150,
                    bbox_inches="tight")
        plt.close(fig)
        written += 1
    return written
