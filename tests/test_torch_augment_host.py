"""The port's host augmentations (yolov5m_tpu_torch/data/augment.py)
against the JAX package's with cv2: TrainAugment (every op forced on in
turn: rotate, blur, CLAHE, posterize, channel shuffle), augment_hsv and
mosaic4 on the same images, labels and generators give EXACTLY the same
result. The port runs its own C ops (csrc/augment.cc) and no cv2: each
case runs once with cv2 importable and once with cv2 made unimportable
for the port (the JAX package keeps the cv2 it imported), as on the
card's machine, which has none."""

import sys

import numpy as np
import pytest

from yolov5m_tpu.data import augment as jaug
from yolov5m_tpu_torch.data import augment as aug


@pytest.fixture(params=["cv2", "no_cv2"])
def cv2_mode(request, monkeypatch):
    assert jaug.cv2 is not None, "the reference is the JAX package with cv2"
    assert not hasattr(aug, "cv2")
    if request.param == "no_cv2":
        monkeypatch.setitem(sys.modules, "cv2", None)
    return request.param


def _item(rng, h=48, w=48, n=4):
    img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    lab = np.zeros((n, 5), np.float32)
    lab[:, 0] = rng.integers(0, 5, n)
    lab[:, 1:3] = rng.uniform(0.15, 0.85, (n, 2))
    lab[:, 3:5] = rng.uniform(0.05, 0.4, (n, 2))
    return img, lab


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", range(6))
def test_train_augment_equals_jax(seed, cv2_mode):
    # every op forced on in turn across seeds; batch parity toggles the
    # transpose
    kw = dict(rotate_p=0.9, blur_p=0.5, clahe_p=0.5, posterize_p=0.5,
              channel_shuffle_p=0.5)
    img, lab = _item(np.random.default_rng(seed), 48, 48 if seed % 3 else 40)
    for batch_idx in (0, 1):
        got = aug.TrainAugment(seed=seed, **kw)(
            img, lab, batch_idx, rng=np.random.default_rng(seed))
        want = jaug.TrainAugment(seed=seed, **kw)(
            img, lab, batch_idx, rng=np.random.default_rng(seed))
        _equal(got, want)
    # the shared generator path (no per-item rng)
    _equal(aug.TrainAugment(seed=seed)(img, lab, 2),
           jaug.TrainAugment(seed=seed)(img, lab, 2))
    empty = np.zeros((0, 5), np.float32)
    _equal(aug.TrainAugment(seed=seed)(img, empty, 0),
           jaug.TrainAugment(seed=seed)(img, empty, 0))


@pytest.mark.parametrize("gains", [None, (1.01, 0.5, 1.3), (0.985, 1.7, 0.6)])
def test_augment_hsv_equals_jax(gains, cv2_mode):
    img, _ = _item(np.random.default_rng(3), 32, 40)
    got = aug.augment_hsv(img, np.random.default_rng(4),
                          gains=None if gains is None else np.asarray(gains))
    want = jaug.augment_hsv(img, np.random.default_rng(4),
                            gains=None if gains is None else np.asarray(gains))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got is not img


@pytest.mark.parametrize("center", [None, (24, 40), (16, 16), (47, 47)])
def test_mosaic4_equals_jax(center, cv2_mode):
    rng = np.random.default_rng(7)
    items = [_item(rng, n=n) for n in (3, 0, 2, 5)]
    got = aug.mosaic4(items, 32, np.random.default_rng(9), center=center)
    want = jaug.mosaic4(items, 32, np.random.default_rng(9), center=center)
    _equal(got, want)
    no_labels = [(img, np.zeros((0, 5), np.float32)) for img, _ in items]
    _equal(aug.mosaic4(no_labels, 32, np.random.default_rng(1)),
           jaug.mosaic4(no_labels, 32, np.random.default_rng(1)))


def test_color_jitter_factors_equal_jax():
    img, _ = _item(np.random.default_rng(11))
    f = (1.1, 0.85, 1.2)
    np.testing.assert_array_equal(
        aug.TrainAugment._color_jitter(img, None, factors=f),
        jaug.TrainAugment._color_jitter(img, None, factors=f))


@pytest.mark.parametrize("op", ["rotate", "blur", "clahe", "posterize",
                                "channel_shuffle", "defaults"])
@pytest.mark.parametrize("hw", [(48, 48), (37, 53), (64, 40)])
def test_each_op_forced_equals_jax(op, hw, cv2_mode):
    """Each op alone at p 1 (or the default probabilities) over seeds and
    both batch parities: images and labels equal the JAX package's."""
    names = ["rotate", "blur", "clahe", "posterize", "channel_shuffle"]
    kw = {} if op == "defaults" else {
        f"{n}_p": float(n == op) for n in names}
    for seed in range(4):
        img, lab = _item(np.random.default_rng(seed), *hw)
        for batch_idx in (0, 1):
            got = aug.TrainAugment(seed=seed, **kw)(
                img, lab, batch_idx, rng=np.random.default_rng(seed))
            want = jaug.TrainAugment(seed=seed, **kw)(
                img, lab, batch_idx, rng=np.random.default_rng(seed))
            _equal(got, want)


def test_calls_count_each_op():
    aug.reset_calls()
    img, lab = _item(np.random.default_rng(0))
    kw = dict(rotate_p=1.0, blur_p=1.0, clahe_p=1.0)
    aug.TrainAugment(seed=0, **kw)(img, lab, 1, rng=np.random.default_rng(0))
    aug.augment_hsv(img, np.random.default_rng(1))
    aug.mosaic4([(img, lab)] * 4, 32, np.random.default_rng(2))
    assert aug.calls == {"rotate": 1, "blur": 1, "clahe": 1, "hsv": 1,
                         "downscale": 1}
    aug.reset_calls()
    assert set(aug.calls.values()) == {0}
