"""Seeded cases of the host augmentation's C ops, and the digests of cv2's
outputs on them (tests/fixtures/torch_cv_ops_digests.json).

Each case is an op of yolov5m_tpu_torch/csrc/augment.cc (through
data/native.py and data/augment.py) on inputs made from a numpy seed, at
the sizes the loader gives it (the flagship's 640, the mosaic's 1280
canvas, non-square scenes) and at odd ones: rotations over +-20 degrees,
blur at k 3, 5 and 7, the four colour conversions over all 2^24 colours
(and one colour a row, for cv2's scalar code), CLAHE on planes and on an
RGB image through Lab, the HSV gains, and the 2x downscale. ``digests.json``
holds the sha256 of each output as cv2 gives it; chip_smoke.py holds the
port's ops to them on a machine without cv2 (its build rounds as this one
does: csrc/augment.cc turns off floating-point contraction), and
tests/test_torch_cv_ops.py holds the digests to cv2 and to the port here.
Remake them (cv2 needed) with

  python -m tests.torch_cv_ops_cases
"""

import hashlib
import json
import os
import sys

import numpy as np

DIGESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "torch_cv_ops_digests.json")
ROTATIONS = ((-20.0, 640, 640), (-7.5, 480, 640), (13.25, 640, 640),
             (20.0, 53, 37), (0.5, 540, 960))
BLURS = ((3, 640, 640), (5, 53, 37), (7, 640, 640), (7, 480, 640))
CLAHES = ((640, 640), (480, 640), (53, 37), (9, 7))
HSV_GAINS = (1.01, 0.5, 1.3)


def image(seed: int, h: int, w: int) -> np.ndarray:
    """float32 (h, w, 3) in [0, 255): a ramp with noise."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0, 200, w, dtype=np.float32)[None, :, None]
    return ramp + rng.uniform(0, 55, (h, w, 3)).astype(np.float32)


def plane(seed: int, h: int, w: int) -> np.ndarray:
    """uint8 (h, w) with a ramp, so that the tiles' histograms differ."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 127, (h, w)) + np.linspace(0, 120, w)[None]
            ).clip(0, 255).astype(np.uint8)


def colours(one_per_row: bool = False) -> np.ndarray:
    c = np.arange(256, dtype=np.uint8)
    grid = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1)
    return grid.reshape((-1, 1, 3) if one_per_row else (4096, 4096, 3))


def _rotation(angle, h, w):
    from yolov5m_tpu_torch.data.augment import rotation_matrix

    return rotation_matrix((w / 2, h / 2), angle)


def port_cases() -> dict:
    """{name: () -> the port's output}."""
    from yolov5m_tpu_torch.data import augment, native

    cases = {}
    for angle, h, w in ROTATIONS:
        cases[f"rotate_{angle}_{w}x{h}"] = (
            lambda a=angle, h=h, w=w: native.warp_affine(
                image(h + w, h, w), _rotation(a, h, w), (w, h)))
    for k, h, w in BLURS:
        cases[f"blur_k{k}_{w}x{h}"] = (
            lambda k=k, h=h, w=w: native.box_blur(image(k * h + w, h, w), k))
    for name in ("rgb_to_hsv", "hsv_to_rgb", "rgb_to_lab", "lab_to_rgb"):
        cases[f"{name}_every_colour"] = (
            lambda n=name: getattr(native, n)(colours()))
    cases["hsv_to_rgb_one_per_row"] = lambda: native.hsv_to_rgb(
        colours(True))
    for h, w in CLAHES:
        cases[f"clahe_{w}x{h}"] = (
            lambda h=h, w=w: native.clahe(plane(h * 7 + w, h, w)))
    cases["clahe_rgb_640x640"] = lambda: augment.TrainAugment._clahe(
        image(6, 640, 640))
    cases["hsv_gains_640x640"] = lambda: augment.augment_hsv(
        image(7, 640, 640), None, gains=np.asarray(HSV_GAINS))
    cases["downscale_1280x1280"] = lambda: native.downscale2x(
        image(8, 1280, 1280))
    cases["downscale_40x64"] = lambda: native.downscale2x(image(9, 64, 40))
    return cases


def cv2_cases() -> dict:
    """{name: () -> cv2's output}, the same names as port_cases."""
    import cv2

    def rotate(angle, h, w):
        m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
        return cv2.warpAffine(image(h + w, h, w), m, (w, h),
                              flags=cv2.INTER_LINEAR, borderValue=0)

    def clahe(p):
        return cv2.createCLAHE(clipLimit=4.0, tileGridSize=(8, 8)).apply(p)

    def clahe_rgb(img):
        lab = cv2.cvtColor(np.clip(img, 0, 255).astype(np.uint8),
                           cv2.COLOR_RGB2LAB)
        lab[..., 0] = clahe(lab[..., 0])
        return cv2.cvtColor(lab, cv2.COLOR_LAB2RGB).astype(np.float32)

    def hsv_gains(img, r):
        hue, sat, val = cv2.split(cv2.cvtColor(
            np.clip(img, 0, 255).astype(np.uint8), cv2.COLOR_RGB2HSV))
        x = np.arange(256)
        luts = (((x * r[0]) % 180).astype(np.uint8),
                np.clip(x * r[1], 0, 255).astype(np.uint8),
                np.clip(x * r[2], 0, 255).astype(np.uint8))
        merged = cv2.merge([cv2.LUT(c, t) for c, t in zip((hue, sat, val),
                                                          luts)])
        return cv2.cvtColor(merged, cv2.COLOR_HSV2RGB).astype(np.float32)

    def down(img):
        h, w = img.shape[:2]
        return cv2.resize(img, (w // 2, h // 2),
                          interpolation=cv2.INTER_LINEAR)

    codes = {"rgb_to_hsv": cv2.COLOR_RGB2HSV, "hsv_to_rgb": cv2.COLOR_HSV2RGB,
             "rgb_to_lab": cv2.COLOR_RGB2LAB, "lab_to_rgb": cv2.COLOR_LAB2RGB}
    cases = {}
    for angle, h, w in ROTATIONS:
        cases[f"rotate_{angle}_{w}x{h}"] = (
            lambda a=angle, h=h, w=w: rotate(a, h, w))
    for k, h, w in BLURS:
        cases[f"blur_k{k}_{w}x{h}"] = (
            lambda k=k, h=h, w=w: cv2.blur(image(k * h + w, h, w), (k, k)))
    for name, code in codes.items():
        cases[f"{name}_every_colour"] = (
            lambda c=code: cv2.cvtColor(colours(), c))
    cases["hsv_to_rgb_one_per_row"] = lambda: cv2.cvtColor(
        colours(True), cv2.COLOR_HSV2RGB)
    for h, w in CLAHES:
        cases[f"clahe_{w}x{h}"] = lambda h=h, w=w: clahe(plane(h * 7 + w, h, w))
    cases["clahe_rgb_640x640"] = lambda: clahe_rgb(image(6, 640, 640))
    cases["hsv_gains_640x640"] = lambda: hsv_gains(image(7, 640, 640),
                                                   HSV_GAINS)
    cases["downscale_1280x1280"] = lambda: down(image(8, 1280, 1280))
    cases["downscale_40x64"] = lambda: down(image(9, 64, 40))
    return cases


def digest(out: np.ndarray) -> str:
    """sha256 of an output's dtype, shape and bytes."""
    out = np.ascontiguousarray(out)
    h = hashlib.sha256(f"{out.dtype.str} {out.shape}".encode())
    h.update(out.tobytes())
    return h.hexdigest()


def load() -> dict:
    with open(DIGESTS) as f:
        return json.load(f)


def write() -> dict:
    """cv2's digest of every case into digests.json; returns them."""
    digests = {name: digest(fn()) for name, fn in sorted(cv2_cases().items())}
    with open(DIGESTS, "w") as f:
        f.write("{\n" + ",\n".join(f" {json.dumps(k)}: {json.dumps(v)}"
                                   for k, v in digests.items()) + "\n}\n")
    return digests


if __name__ == "__main__":
    print(json.dumps(write(), indent=1, sort_keys=True), file=sys.stdout)
