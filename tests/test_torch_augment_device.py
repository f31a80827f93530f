"""The port's device augmentations (yolov5m_tpu_torch/ops/augment_device.py)
against the JAX package's, given the same draws (JAX and torch random
streams differ): hsv_jitter, color_jitter, rotate_image, the rotated
labels and flips, within 1e-6 on [0, 1] images, with labels and masks
equal (the rotated labels within 1e-6: cos and sin of the same f32 angle
may differ by an ulp between libraries). device_augment_batch is held to
the explicit-draw functions applied in its order (mosaic -> HSV -> color
jitter -> flips -> rotate) with the draws made again from the same seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov5m_tpu.ops import augment_device as jad
from yolov5m_tpu_torch.ops import augment_device as ad
from yolov5m_tpu_torch.ops.mosaic import random_mosaic_batch

torch.set_num_threads(1)

B, H, W, NB = 4, 32, 48, 5


def _data(seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (B, h, w, 3)).astype(np.float32)
    images[0, :4] = 0.0                       # a black band (v = 0)
    images[1, :, :4] = 0.5                    # a gray band (c = 0)
    labels = np.zeros((B, NB, 5), np.float32)
    mask = np.zeros((B, NB), bool)
    for b in range(B):
        n = int(rng.integers(1, NB + 1))
        labels[b, :n, 0] = rng.integers(0, 4, n)
        labels[b, :n, 1:3] = rng.uniform(0.05, 0.95, (n, 2))
        labels[b, :n, 3:5] = rng.uniform(0.05, 0.6, (n, 2))
        mask[b, :n] = True
    labels[~mask] = 7.0                       # padding must stay untouched
    return images, labels, mask


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1])
def test_hsv_jitter_equals_jax(seed):
    images, _, _ = _data(seed)
    gains = np.random.default_rng(seed + 10).uniform(-1, 1, (B, 3)) \
        * [jad.HGAIN * 20, jad.SGAIN, jad.VGAIN] + 1
    gains = gains.astype(np.float32)
    got = ad.hsv_jitter(*_t(images, gains))
    want = jax.vmap(jad.hsv_jitter)(jnp.asarray(images), jnp.asarray(gains))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_color_jitter_equals_jax():
    images, _, _ = _data(2)
    factors = np.random.default_rng(3).uniform(0.8, 1.2, (B, 3)).astype(
        np.float32)
    got = ad.color_jitter(*_t(images, factors))
    want = jax.vmap(jad.color_jitter)(jnp.asarray(images),
                                      jnp.asarray(factors))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


ANGLES = np.asarray([-20.0, -7.5, 3.25, 19.9], np.float32)


@pytest.mark.parametrize("hw", [(H, W), (40, 40)])
def test_rotate_image_equals_jax(hw):
    images, _, _ = _data(4, *hw)
    got = ad.rotate_image(*_t(images, ANGLES))
    want = jax.vmap(jad.rotate_image)(jnp.asarray(images),
                                      jnp.asarray(ANGLES))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_rotate_labels_and_batch_equal_jax():
    images, labels, mask = _data(5)
    got_lab, got_mask = ad.rotate_labels(*_t(labels, mask, ANGLES), W, H)
    want_lab, want_mask = jax.vmap(
        lambda lab, msk, ang: jad._rotate_labels(lab, msk, ang, W, H,
                                                 jad.MIN_VISIBILITY))(
        jnp.asarray(labels), jnp.asarray(mask), jnp.asarray(ANGLES))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got_lab.numpy(), np.asarray(want_lab),
                               rtol=0, atol=1e-6)
    # rows where do is False stay as they were
    do = np.asarray([True, False, True, False])
    img, lab, msk = ad.rotate_batch(*_t(images, labels, mask, do, ANGLES))
    assert torch.equal(img[1], torch.from_numpy(images[1]))
    assert torch.equal(lab[3], torch.from_numpy(labels[3]))
    np.testing.assert_array_equal(msk.numpy()[0], np.asarray(want_mask)[0])


def test_flip_batch_equals_jax(monkeypatch):
    images, labels, mask = _data(6)
    do_h = np.asarray([True, False, True, False])
    do_v = np.asarray([True, True, False, False])
    got = ad.flip_batch(*_t(images, labels, mask, do_h, do_v))
    # the JAX flip_batch draws its booleans: hand it these
    draws = iter([do_h, do_v])
    monkeypatch.setattr(jad.jax.random, "uniform",
                        lambda key, shape: jnp.where(next(draws), 0.0, 1.0))
    want = jad.flip_batch(jax.random.PRNGKey(0), jnp.asarray(images),
                          jnp.asarray(labels), jnp.asarray(mask), 0.5, 0.5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_device_augment_batch_order_and_draws():
    images, labels, mask = _data(7, 32, 32)
    args = _t(images, labels, mask)
    kw = dict(mosaic_p=0.5, hsv=True, hflip_p=0.5, vflip_p=0.5, cj_p=0.4,
              rotate_p=0.7)
    got = ad.device_augment_batch(torch.Generator().manual_seed(3), *args,
                                  **kw)
    gen = torch.Generator().manual_seed(3)
    img, lab, msk = random_mosaic_batch(gen, *args, 0.5)
    gains = (torch.rand((B, 3), generator=gen) * 2 - 1) * torch.tensor(
        [ad.HGAIN, ad.SGAIN, ad.VGAIN]) + 1
    img = ad.hsv_jitter(img, gains)
    do = torch.rand((B,), generator=gen) < 0.4
    factors = 0.8 + 0.4 * torch.rand((B, 3), generator=gen)
    img = torch.where(do[:, None, None, None], ad.color_jitter(img, factors),
                      img)
    do_h = torch.rand((B,), generator=gen) < 0.5
    do_v = torch.rand((B,), generator=gen) < 0.5
    img, lab, msk = ad.flip_batch(img, lab, msk, do_h, do_v)
    do = torch.rand((B,), generator=gen) < 0.7
    angles = (2 * torch.rand((B,), generator=gen) - 1) * 20.0
    want = ad.rotate_batch(img, lab, msk, do, angles)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # nothing asked: nothing changes
    same = ad.device_augment_batch(None, *args, hsv=False, hflip_p=0.0,
                                   vflip_p=0.0)
    for s, a in zip(same, args):
        assert torch.equal(s, a)
