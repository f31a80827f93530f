"""The port's device mosaic (yolov5m_tpu_torch/ops/mosaic.py) against the
JAX package's mosaic_batch on the same images, labels, masks, partner
indices and centers: images within 1e-6 on [0, 1] (they come out equal),
labels and masks equal. The centers span [S/2, 3S/2) including its
corners and odd values (both round them down to even). Also: the host
mosaic4 at the same even center, label compaction into the fixed capacity
in source order, and random_mosaic_batch at p 0 and 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov5m_tpu.ops.mosaic import mosaic_batch as jmosaic_batch
from yolov5m_tpu_torch.data.augment import mosaic4
from yolov5m_tpu_torch.ops.mosaic import mosaic_batch, random_mosaic_batch

torch.set_num_threads(1)

S, NB, B = 64, 6, 5


def _batch(seed):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32)
    labels = np.zeros((B, NB, 5), np.float32)
    mask = np.zeros((B, NB), bool)
    for b in range(B):
        n = int(rng.integers(0, NB + 1))
        labels[b, :n, 0] = rng.integers(0, 4, n)
        labels[b, :n, 1:3] = rng.uniform(0.1, 0.9, (n, 2))
        labels[b, :n, 3:5] = rng.uniform(0.05, 0.5, (n, 2))
        mask[b, :n] = True
    idx = rng.integers(0, B, (B, 4)).astype(np.int32)
    return images, labels, mask, idx


CENTERS = [[(54, 86)] * B, [(32, 32), (95, 95), (32, 95), (95, 32), (63, 65)],
           [(33, 41), (77, 59), (90, 34), (50, 50), (64, 64)]]


@pytest.mark.parametrize("centers", CENTERS, ids=["interior", "corners",
                                                  "odd"])
@pytest.mark.parametrize("seed", [0, 1])
def test_mosaic_batch_equals_jax(centers, seed):
    images, labels, mask, idx = _batch(seed)
    centers = np.asarray(centers, np.int32)
    got = mosaic_batch(*(torch.from_numpy(a) for a in
                         (images, labels, mask, idx, centers)))
    want = jmosaic_batch(*(jnp.asarray(a) for a in
                           (images, labels, mask, idx, centers)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_matches_host_mosaic4_at_an_even_center():
    images, labels, mask, _ = _batch(3)
    idx = np.asarray([[0, 1, 2, 3]] * B, np.int32)
    centers = np.asarray([[40, 70]] * B, np.int32)
    img, lab, msk = mosaic_batch(*(torch.from_numpy(a) for a in
                                   (images, labels, mask, idx, centers)))
    items = [(images[k] * 255, labels[k][mask[k]]) for k in range(4)]
    img_h, lab_h = mosaic4(items, S, np.random.default_rng(0),
                           center=(40, 70))
    # the host's 2x2 lerps (cv2's INTER_LINEAR at 0.5) against the device's
    # float 2x2 mean
    np.testing.assert_allclose(img[0].numpy(), img_h / 255, atol=2.5 / 255)
    got = lab[0].numpy()[msk[0].numpy()]
    want = lab_h[:NB]                    # the fixed capacity keeps the first
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_random_mosaic_batch_p0_and_p1():
    images, labels, mask, _ = _batch(4)
    args = [torch.from_numpy(a) for a in (images, labels, mask)]
    out = random_mosaic_batch(torch.Generator().manual_seed(0), *args, p=0.0)
    for o, a in zip(out, args):
        assert torch.equal(o, a)
    gen = torch.Generator().manual_seed(1)
    img, lab, msk = random_mosaic_batch(gen, *args, p=1.0)
    # the same draws, made again, give the same mosaics
    gen = torch.Generator().manual_seed(1)
    partners = torch.randint(0, B, (B, 3), generator=gen)
    centers = torch.randint(S // 2, 3 * S // 2, (B, 2), generator=gen)
    idx = torch.cat([torch.arange(B)[:, None], partners], 1)
    want = mosaic_batch(*args, idx, centers)
    for o, w in zip((img, lab, msk), want):
        assert torch.equal(o, w)
    assert img.shape == args[0].shape and lab.shape == args[1].shape
