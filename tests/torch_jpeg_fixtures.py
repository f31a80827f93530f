"""The committed JPEG fixtures of the port (tests/fixtures/torch_jpeg/):
structured scenes at 640x480 and 960x540, made from a seed with numpy and
encoded by PIL at quality 90.

Each scene is the synthetic training distribution of data/synthetic.py
(class-colored rectangles on dark noise, 80 classes) drawn with numpy at
640x640, with the noise cut to a fifth so that quality 90 stays within
about 2 codes of the source, then resized with the port's numpy resize to
the fixture's size. ``scene(i)`` remakes a fixture's source pixels
anywhere (no PIL needed); ``write(folder)`` remakes the JPEG files:

  python -m tests.torch_jpeg_fixtures tests/fixtures/torch_jpeg
"""

import os
import sys

import numpy as np

FOLDER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                      "torch_jpeg")
# (h, w) of scene i
SIZES = ((480, 640), (540, 960)) * 3
QUALITY = 90


def name(i: int) -> str:
    h, w = SIZES[i]
    return f"scene{i}_{w}x{h}.jpg"


def scene(i: int, nc: int = 80, max_boxes: int = 8,
          noise: float = 0.05) -> np.ndarray:
    """The (h, w, 3) uint8 source of fixture i."""
    from yolov5m_tpu_torch.data.native import resize_bilinear_plain
    from yolov5m_tpu_torch.data.synthetic import class_palette

    rng = np.random.default_rng(i)
    palette = class_palette(nc)
    n = int(rng.integers(3, max_boxes + 1))
    cls = rng.integers(0, nc, n)
    wh = 0.06 + 0.36 * rng.random((n, 2))
    cxy = wh / 2 + rng.random((n, 2)) * (1 - wh)
    amp = 0.5 + 0.5 * rng.random()
    img = rng.random((640, 640, 3), dtype=np.float32) * np.float32(noise * amp)
    c = (np.arange(640, dtype=np.float32) + 0.5) / 640
    for k in range(n):
        (x1, y1), (x2, y2) = cxy[k] - wh[k] / 2, cxy[k] + wh[k] / 2
        inside = ((c[:, None] >= y1) & (c[:, None] < y2)
                  & (c[None] >= x1) & (c[None] < x2))
        img[inside] = palette[cls[k]]
    h, w = SIZES[i]
    return resize_bilinear_plain(np.round(img * 255).astype(np.uint8), (w, h))


def write(folder: str = FOLDER) -> list:
    """Encode every scene as a JPEG in folder; returns the paths."""
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    paths = []
    for i in range(len(SIZES)):
        path = os.path.join(folder, name(i))
        Image.fromarray(scene(i)).save(path, "JPEG", quality=QUALITY)
        paths.append(path)
    return paths


if __name__ == "__main__":
    print("\n".join(write(*sys.argv[1:])))
