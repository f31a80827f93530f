"""Seeded cases of the prediction images, and the digests of the JAX
package's images on them (tests/fixtures/torch_plot_digests.json).

Each case is a call of ``plot_image`` or ``save_prediction_images`` (the JAX
package's ``yolov5m_tpu/utils/plotting.py`` and the port's
``yolov5m_tpu_torch/utils/plotting.py``) on inputs made from a numpy seed:

- ``plot_image`` at 640x480, 960x540 (a letterbox's raw frame), 480x640
  and 64x64 (upsampled past 3x: nearest), with 0, 1 and 20 boxes, boxes
  clipped at every edge, labels that run past the right and bottom edges,
  a class beyond the label list (drawn as its number), confidences that
  round at .2f, the COCO and the FLIR label lists, and a float64 image;
- ``save_prediction_images`` with num_images 2 of 3 images, and with an
  empty row set on one side.

``digests.json`` holds, for each file the case writes, the sha256 of the
decoded RGBA and its shape, as the JAX package writes it with matplotlib
3.10.8. chip_smoke.py holds the port to them on a machine without
matplotlib, and tests/test_torch_plotting.py holds the digests to the JAX
package and the port here. Remake them (matplotlib needed) with

  python -m tests.torch_plot_cases
"""

import hashlib
import json
import os
import sys
import tempfile

import numpy as np

DIGESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "torch_plot_digests.json")

COCO = "coco"
FLIR = "flir"


def image(seed: int, h: int, w: int, dtype=np.float32) -> np.ndarray:
    """(h, w, 3) in [0, 1]: a ramp with noise."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0.0, 0.7, w)[None, :, None]
    return (ramp + rng.uniform(0, 0.3, (h, w, 3))).astype(dtype)


def rows(seed: int, n: int, h: int, w: int, nc: int = 80,
         edges: bool = False) -> np.ndarray:
    """(n, 6) float32 rows (class, conf, x1, y1, x2, y2) in pixels; with
    edges, boxes that cross or lie past every edge of the image."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, 6), np.float32)
    out[:, 0] = rng.integers(0, nc, n)
    out[:, 1] = rng.uniform(0.05, 1.0, n)
    x1 = rng.uniform(0, w * 0.9, n)
    y1 = rng.uniform(0, h * 0.9, n)
    out[:, 2] = x1
    out[:, 3] = y1
    out[:, 4] = x1 + rng.uniform(2, w * 0.5, n)
    out[:, 5] = y1 + rng.uniform(2, h * 0.5, n)
    if edges:
        k = np.arange(n) % 6
        out[k == 0, 2] = -rng.uniform(1, 40, (k == 0).sum())
        out[k == 1, 3] = -rng.uniform(1, 40, (k == 1).sum())
        out[k == 2, 4] = w + rng.uniform(1, 40, (k == 2).sum())
        out[k == 3, 5] = h + rng.uniform(1, 40, (k == 3).sum())
        out[k == 4, 2:6] = (w + 5, h + 5, w + 30, h + 30)   # all outside
        out[k == 5, 2:6] = (-30, -30, -5, -5)
    return out


def labels(name: str):
    from yolov5m_tpu_torch.config import COCO_LABELS, FLIR_LABELS
    return {COCO: COCO_LABELS, FLIR: FLIR_LABELS}[name]


def _plot(seed, h, w, rws, label_set=COCO, dtype=np.float32):
    return ("plot_image", dict(seed=seed, h=h, w=w, dtype=dtype,
                               rows=rws, labels=label_set))


def cases() -> dict:
    """name -> (function, its inputs)."""
    out = {}
    out["plot_640x480_0"] = _plot(1, 480, 640, rows(1, 0, 480, 640))
    out["plot_640x480_1"] = _plot(2, 480, 640, rows(2, 1, 480, 640))
    out["plot_640x480_20"] = _plot(3, 480, 640, rows(3, 20, 480, 640))
    out["plot_640x480_edges"] = _plot(4, 480, 640,
                                      rows(4, 12, 480, 640, edges=True))
    # labels past the right and the bottom edges
    past = np.array([[0, 0.91, 620, 200, 639, 260],
                     [1, 0.5, 300, 470, 340, 480],
                     [79, 0.999, 630, 476, 640, 480]], np.float32)
    out["plot_640x480_past_edges"] = _plot(5, 480, 640, past)
    out["plot_960x540_20"] = _plot(6, 540, 960, rows(6, 20, 540, 960))
    out["plot_480x640_edges"] = _plot(7, 640, 480,
                                      rows(7, 12, 640, 480, edges=True))
    out["plot_64x64_edges"] = _plot(8, 64, 64, rows(8, 6, 64, 64, edges=True))
    # a class beyond the list, confidences that round at .2f
    odd = np.array([[80, 0.005, 10, 10, 100, 100],
                    [3, 0.125, 200, 50, 300, 150],
                    [7, 0.995, 400, 300, 500, 400],
                    [12, 0.3449, 50, 300, 120, 420]], np.float32)
    out["plot_640x480_odd"] = _plot(9, 480, 640, odd)
    out["plot_640x480_flir"] = _plot(10, 480, 640,
                                     rows(10, 8, 480, 640, nc=3), FLIR)
    out["plot_640x480_f64"] = _plot(11, 480, 640, rows(11, 5, 480, 640),
                                    dtype=np.float64)
    out["pred_640x480_2of3"] = ("save_prediction_images", dict(
        seeds=(12, 13, 14), h=480, w=640, num_images=2,
        gt=[rows(15, 3, 480, 640), rows(16, 0, 480, 640),
            rows(17, 2, 480, 640)],
        pred=[rows(18, 5, 480, 640, edges=True), rows(19, 4, 480, 640),
              rows(20, 1, 480, 640)], labels=COCO))
    out["pred_640x480_empty_pred"] = ("save_prediction_images", dict(
        seeds=(21,), h=480, w=640, num_images=5,
        gt=[rows(22, 4, 480, 640)], pred=[rows(23, 0, 480, 640)],
        labels=COCO))
    return out


def run(plotting, name: str, case, folder: str) -> list:
    """Call the case on a plotting module (the JAX package's or the
    port's); returns the files it wrote, in order."""
    fn, kw = case
    lab = labels(kw["labels"])
    os.makedirs(folder, exist_ok=True)
    if fn == "plot_image":
        img = image(kw["seed"], kw["h"], kw["w"], kw["dtype"])
        path = os.path.join(folder, f"{name}.png")
        plotting.plot_image(img, kw["rows"], lab, save_path=path)
        return [path]
    imgs = np.stack([image(s, kw["h"], kw["w"]) for s in kw["seeds"]])
    n = plotting.save_prediction_images(imgs, kw["pred"], kw["gt"], folder,
                                        name, 0, lab, kw["num_images"])
    return [os.path.join(folder, name, "EPOCH_0", f"image_{i}.png")
            for i in range(n)]


def rgba_digest(rgba: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(rgba).tobytes()).hexdigest()


def decode(path: str) -> np.ndarray:
    """The RGBA of a PNG as the port writes it (8-bit RGBA, no interlace,
    filter type 0 on every row), with zlib and numpy; other files raise."""
    import struct
    import zlib
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, w, h = 8, [], None, None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB",
                                                                body)
            if (depth, ctype, interlace) != (8, 6, 0):
                raise ValueError(f"{path}: not 8-bit RGBA")
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, w * 4 + 1)
    if raw[:, 0].any():
        raise ValueError(f"{path}: rows with a filter")
    return raw[:, 1:].reshape(h, w, 4).copy()


def decode_reference(path: str) -> np.ndarray:
    """The RGBA of any PNG, through Pillow (the JAX package's files)."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA")).copy()


def main(path: str = DIGESTS) -> None:
    from yolov5m_tpu.utils import plotting
    digests = {}
    with tempfile.TemporaryDirectory() as folder:
        for name, case in cases().items():
            files = run(plotting, name, case, folder)
            rgbas = [decode_reference(f) for f in files]
            digests[name] = [{"sha256": rgba_digest(a), "shape": list(a.shape)}
                             for a in rgbas]
    with open(path, "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{path}: {len(digests)} cases")


if __name__ == "__main__":
    main(*sys.argv[1:])
