"""The port's synthetic scenes (yolov5m_tpu_torch/data/synthetic.py) against
the JAX package's: the palette exactly, the batch by its structure. The
JAX key stream cannot be reproduced with a torch.Generator, so the batch
is held to the same distribution's invariants, not the same pixels."""

import jax
import numpy as np
import pytest
import torch

from yolov5m_tpu.data.synthetic import class_palette as jax_palette
from yolov5m_tpu.data.synthetic import synth_batch as jax_synth
from yolov5m_tpu_torch.data.synthetic import class_palette, synth_batch, to_uint8

torch.set_num_threads(1)


@pytest.mark.parametrize("nc", (1, 2, 4, 37, 80))
def test_palette_matches_jax(nc):
    np.testing.assert_array_equal(class_palette(nc), jax_palette(nc))


def _invariants(img, labels, mask, bs, hw, nc):
    assert img.shape == (bs, hw, hw, 3) and labels.shape == (bs, 8, 5)
    assert mask.shape == (bs, 8) and mask.dtype == bool
    assert img.min() >= 0.0 and img.max() <= 1.0
    assert (mask.sum(1) >= 1).all() and mask[:, 0].all()
    # a sorted prefix of boxes is present; absent rows are zeroed
    assert (np.diff(mask.astype(int), axis=1) <= 0).all()
    assert (labels[~mask] == 0).all()
    cls, cxy, wh = labels[..., 0], labels[..., 1:3], labels[..., 3:5]
    m = mask
    assert (cls[m] >= 0).all() and (cls[m] < nc).all()
    assert (wh[m] >= 0.06).all() and (wh[m] <= 0.42).all()
    assert (cxy[m] - wh[m] / 2 >= -1e-6).all()
    assert (cxy[m] + wh[m] / 2 <= 1 + 1e-6).all()
    # the last painted box shows its class color at its center
    pal = class_palette(nc)
    for b in range(bs):
        k = int(mask[b].sum()) - 1
        cx, cy = labels[b, k, 1:3]
        px = img[b, int(cy * hw), int(cx * hw)]
        np.testing.assert_allclose(px, pal[int(labels[b, k, 0])], atol=1e-6)
    # background is low noise: most pixels of a frame are boxes or < .25
    assert (img < 0.25 + 1e-6).mean() > 0.1


def test_synth_batch_structure_matches_jax():
    bs, hw, nc = 16, 64, 5
    g = torch.Generator().manual_seed(0)
    img, labels, mask = (t.numpy() for t in synth_batch(g, bs, hw, nc))
    _invariants(img, labels, mask, bs, hw, nc)
    j_img, j_labels, j_mask = (np.asarray(a) for a in jax_synth(
        jax.random.PRNGKey(0), bs, hw, nc))
    _invariants(j_img, j_labels, j_mask, bs, hw, nc)
    # same generator seed, same batch; another seed, another batch
    again = synth_batch(torch.Generator().manual_seed(0), bs, hw, nc)[0]
    other = synth_batch(torch.Generator().manual_seed(1), bs, hw, nc)[0]
    assert np.array_equal(again.numpy(), img)
    assert not np.array_equal(other.numpy(), img)


def test_to_uint8():
    x = torch.tensor([0.0, 0.5, 1.0, 0.2])
    assert to_uint8(x).tolist() == [0, 128, 255, 51]
