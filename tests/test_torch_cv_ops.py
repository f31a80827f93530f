"""The port's C image ops of the host augmentation
(yolov5m_tpu_torch/csrc/augment.cc, bound in data/native.py) against the
cv2 calls they stand for, bitwise: warpAffine (INTER_LINEAR, border 0) at
angles over +-20 degrees through getRotationMatrix2D, blur at k 3, 5 and
7, the 8-bit RGB <-> HSV and RGB <-> Lab conversions over all 2^24
colours, CLAHE (clip 4, 8 x 8 tiles) and the 2x INTER_LINEAR downscale, on
seeded images of several sizes (odd ones, and ones that are not
multiples of 8) and once each at the flagship's 640."""

import math

import cv2
import numpy as np
import pytest
import torch

from yolov5m_tpu_torch.data import augment, native

torch.set_num_threads(1)

SIZES = [(48, 48), (37, 53), (40, 48), (9, 7), (64, 40), (61, 33)]
ANGLES = [-20.0, -13.7, -0.5, 0.0, 1e-3, 7.3, 19.99, 20.0]


def _image(seed, h, w):
    """float32 (h, w, 3) in [0, 255] with ramps and noise."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0, 200, w, dtype=np.float32)[None, :, None]
    noise = rng.uniform(0, 55, (h, w, 3)).astype(np.float32)
    return ramp + noise


def _plane(seed, h, w):
    """uint8 (h, w) with a ramp, so that the tiles' histograms differ."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 127, (h, w)) + np.linspace(0, 120, w)[None]
            ).clip(0, 255).astype(np.uint8)


def _all_colours():
    c = np.arange(256, dtype=np.uint8)
    grid = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1)
    return grid.reshape(4096, 4096, 3)


@pytest.mark.parametrize("angle", ANGLES)
@pytest.mark.parametrize("hw", SIZES)
def test_rotate_equals_cv2(hw, angle):
    h, w = hw
    img = _image(int(abs(angle) * 100) + h, h, w)
    m = augment.rotation_matrix((w / 2, h / 2), angle)
    np.testing.assert_array_equal(
        m, cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0))
    np.testing.assert_array_equal(
        native.warp_affine(img, m, (w, h)),
        cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR,
                       borderValue=0))


def test_rotation_matrix_equals_cv2_over_angles_and_sizes():
    rng = np.random.default_rng(0)
    for _ in range(2000):
        angle = float(rng.uniform(-20, 20))
        w, h = (int(v) for v in rng.integers(1, 1300, 2))
        np.testing.assert_array_equal(
            augment.rotation_matrix((w / 2, h / 2), angle),
            cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0))


def test_rotate_other_sizes_and_matrices():
    # an output of another size, a scale and a shear: the op is warpAffine
    img = _image(5, 37, 53)
    for m, size in (
            (cv2.getRotationMatrix2D((10.5, 30), 33.0, 0.7), (41, 29)),
            (np.array([[1.1, 0.2, -3.5], [-0.1, 0.9, 2.25]]), (53, 37))):
        np.testing.assert_array_equal(
            native.warp_affine(img, m, size),
            cv2.warpAffine(img, m, size, flags=cv2.INTER_LINEAR,
                           borderValue=0))


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("hw", SIZES)
def test_blur_equals_cv2(hw, k):
    img = _image(k + hw[0], *hw)
    np.testing.assert_array_equal(native.box_blur(img, k),
                                  cv2.blur(img, (k, k)))


def test_blur_on_values_with_small_fractions():
    # float32 values whose double sums are not all exact
    img = _image(3, 29, 31) * np.float32(1.0001) + np.float32(1e-5)
    img[::3, ::5] = np.float32(3e-6)
    for k in (3, 5, 7):
        np.testing.assert_array_equal(native.box_blur(img, k),
                                      cv2.blur(img, (k, k)))


CONVERSIONS = [
    ("rgb_to_hsv", cv2.COLOR_RGB2HSV), ("hsv_to_rgb", cv2.COLOR_HSV2RGB),
    ("rgb_to_lab", cv2.COLOR_RGB2LAB), ("lab_to_rgb", cv2.COLOR_LAB2RGB)]


@pytest.mark.parametrize("layout", ["rows_of_4096", "one_per_row"])
@pytest.mark.parametrize("name,code", CONVERSIONS)
def test_colour_conversions_equal_cv2_on_every_colour(name, code, layout):
    """All 2^24 colours, in rows that cv2's vector code takes whole, and one
    colour a row, which its scalar code takes (HSV -> RGB rounds there
    where the vector code truncates)."""
    colours = _all_colours()
    if layout == "one_per_row":
        colours = colours.reshape(-1, 1, 3)
    np.testing.assert_array_equal(getattr(native, name)(colours),
                                  cv2.cvtColor(colours, code))


@pytest.mark.parametrize("name,code", CONVERSIONS)
def test_colour_conversions_equal_cv2_at_every_row_width(name, code):
    rng = np.random.default_rng(7)
    for w in range(1, 100):
        img = rng.integers(0, 256, (24, w, 3)).astype(np.uint8)
        np.testing.assert_array_equal(getattr(native, name)(img),
                                      cv2.cvtColor(img, code), err_msg=str(w))


@pytest.mark.parametrize("hw", SIZES + [(8, 8), (16, 13), (13, 16),
                                        (1, 1), (3, 100)])
def test_clahe_equals_cv2(hw):
    plane = _plane(hw[0] * 7 + hw[1], *hw)
    want = cv2.createCLAHE(clipLimit=4.0, tileGridSize=(8, 8)).apply(plane)
    np.testing.assert_array_equal(native.clahe(plane), want)


@pytest.mark.parametrize("clip,tiles", [(2.0, (4, 4)), (0.0, (8, 8)),
                                        (40.0, (3, 5))])
def test_clahe_other_settings_equal_cv2(clip, tiles):
    plane = _plane(9, 37, 53)
    want = cv2.createCLAHE(clipLimit=clip, tileGridSize=tiles).apply(plane)
    np.testing.assert_array_equal(native.clahe(plane, clip, tiles), want)


@pytest.mark.parametrize("hw", [(48, 48), (64, 40), (2, 2), (38, 54)])
def test_downscale2x_equals_cv2(hw):
    h, w = hw
    img = _image(h + w, h, w)
    np.testing.assert_array_equal(
        native.downscale2x(img),
        cv2.resize(img, (w // 2, h // 2), interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("op", ["rotate", "blur", "clahe", "hsv",
                                "downscale"])
def test_flagship_size_equals_cv2(op):
    """One call of each op at 640 x 640 (the mosaic's canvas at 1280)."""
    img = _image(640, 640, 640)
    if op == "rotate":
        m = cv2.getRotationMatrix2D((320.0, 320.0), -17.25, 1.0)
        got = native.warp_affine(img, m, (640, 640))
        want = cv2.warpAffine(img, m, (640, 640), flags=cv2.INTER_LINEAR,
                              borderValue=0)
    elif op == "blur":
        got, want = native.box_blur(img, 7), cv2.blur(img, (7, 7))
    elif op == "clahe":
        u8 = np.clip(img, 0, 255).astype(np.uint8)
        got = augment.TrainAugment._clahe(img)
        lab = cv2.cvtColor(u8, cv2.COLOR_RGB2LAB)
        lab[..., 0] = cv2.createCLAHE(clipLimit=4.0,
                                      tileGridSize=(8, 8)).apply(lab[..., 0])
        want = cv2.cvtColor(lab, cv2.COLOR_LAB2RGB).astype(np.float32)
    elif op == "hsv":
        u8 = np.clip(img, 0, 255).astype(np.uint8)
        got = native.hsv_to_rgb(native.rgb_to_hsv(u8))
        want = cv2.cvtColor(cv2.cvtColor(u8, cv2.COLOR_RGB2HSV),
                            cv2.COLOR_HSV2RGB)
    else:
        canvas = _image(1280, 1280, 1280)
        got = native.downscale2x(canvas)
        want = cv2.resize(canvas, (640, 640), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(got, want)


def test_ops_refuse_bad_shapes():
    with pytest.raises(ValueError):
        native.box_blur(_image(0, 8, 8), 4)
    with pytest.raises(ValueError):
        native.downscale2x(_image(0, 9, 8))
    with pytest.raises(ValueError):
        native.rgb_to_hsv(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        native.clahe(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError):
        native.clahe(np.zeros((4, 4), np.uint8), 4.0, (0, 8))
    # empty images give empty results
    assert native.box_blur(np.zeros((0, 5, 3), np.float32), 3).shape == \
        (0, 5, 3)
    assert native.clahe(np.zeros((3, 0), np.uint8)).shape == (3, 0)


def test_ops_raise_naming_the_compiler_when_the_library_cannot_build(
        monkeypatch):
    """Without the library the ops have no other version: they raise, and
    TrainAugment, augment_hsv and mosaic4 refuse at once."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "CXX", "no-such-compiler-g++")
    monkeypatch.setattr(native, "library_path",
                        lambda: "/nonexistent/libpreproc_missing.so")
    with pytest.raises(RuntimeError, match="no-such-compiler-g\\+\\+"):
        native.box_blur(_image(0, 8, 8), 3)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        augment.TrainAugment(seed=0)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        augment.augment_hsv(_image(0, 8, 8), np.random.default_rng(0))
    items = [(_image(i, 16, 16), np.zeros((0, 5), np.float32))
             for i in range(4)]
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        augment.mosaic4(items, 16, np.random.default_rng(0))
    # a pipeline without rotate, blur and CLAHE still builds
    augment.TrainAugment(seed=0, rotate_p=0, blur_p=0, clahe_p=0)


def test_ops_from_threads_equal_one_thread():
    """ctypes releases the GIL: loader threads call the ops at once."""
    from concurrent.futures import ThreadPoolExecutor

    imgs = [_image(i, 96, 80) for i in range(16)]
    m = cv2.getRotationMatrix2D((40.0, 48.0), 11.0, 1.0)

    def work(img):
        out = native.warp_affine(img, m, (80, 96))
        out = native.box_blur(out, 5)
        return native.hsv_to_rgb(native.rgb_to_hsv(out.astype(np.uint8)))

    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(work, imgs))
    for g, img in zip(got, imgs):
        np.testing.assert_array_equal(g, work(img))
    assert math.isfinite(float(np.mean([g.mean() for g in got])))


def test_committed_digests_are_cv2s_and_the_ports():
    """tests/fixtures/torch_cv_ops_digests.json (which chip_smoke.py holds
    the port to on the card) is cv2's output here, and the port's."""
    from tests import torch_cv_ops_cases as cases

    want = cases.load()
    port, ref = cases.port_cases(), cases.cv2_cases()
    assert sorted(want) == sorted(port) == sorted(ref)
    for name in sorted(want):
        assert cases.digest(ref[name]()) == want[name], name
        assert cases.digest(port[name]()) == want[name], name
