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


def test_default_multiscale_sizes_match_jax():
    from yolov5m_tpu.data.loaders import default_multiscale_sizes as jax_ms
    from yolov5m_tpu_torch.data.loaders import default_multiscale_sizes
    for size in (32, 64, 128, 320, 640, 1280):
        assert default_multiscale_sizes(size) == jax_ms(size)


def test_synthetic_loader_streams():
    """Train batches change with (epoch, step) and cycle the sizes largest
    first, like the JAX loader; the eval set is fixed across epochs; the
    image stays a tensor, labels and mask come back as numpy."""
    from yolov5m_tpu_torch.data.synthetic import SyntheticLoader

    train = SyntheticLoader(2, steps=4, image_size=64, nc=5,
                            multi_scale_sizes=[64, 32, 96], device="cpu")
    assert len(train) == 4
    first = list(train)
    assert [b["image"].shape[1] for b in first] == [96, 64, 32, 96]
    for b in first:
        assert isinstance(b["image"], torch.Tensor)
        assert isinstance(b["labels"], np.ndarray) and b["labels"].shape == (2, 8, 5)
        assert isinstance(b["mask"], np.ndarray) and b["mask"].dtype == bool
    again = list(train)
    assert all(np.array_equal(a["labels"], b["labels"])
               for a, b in zip(first, again))
    train.set_epoch(1)
    assert not np.array_equal(next(iter(train))["labels"], first[0]["labels"])

    val = SyntheticLoader(2, steps=2, image_size=64, nc=5, train=False,
                          device="cpu")
    v0 = list(val)
    val.set_epoch(7)
    v7 = list(val)
    assert all(b["image"].shape[1] == 64 for b in v0)
    for a, b in zip(v0, v7):
        assert torch.equal(a["image"], b["image"])
        assert np.array_equal(a["labels"], b["labels"])
    assert not np.array_equal(v0[0]["labels"], first[0]["labels"])


def test_synthetic_loader_rank_rows():
    """Rank r of 2 yields rows [2r, 2r + 2) of each single-process batch of
    4, exactly."""
    from yolov5m_tpu_torch.data.synthetic import SyntheticLoader

    kw = dict(steps=3, image_size=64, nc=5, multi_scale_sizes=[32, 64],
              device="cpu")
    whole = SyntheticLoader(4, **kw)
    whole.set_epoch(2)
    want = list(whole)
    for r in range(2):
        part = SyntheticLoader(4, rank=r, world_size=2, **kw)
        part.set_epoch(2)
        got = list(part)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            rows = slice(2 * r, 2 * r + 2)
            assert torch.equal(g["image"], w["image"][rows])
            assert np.array_equal(g["labels"], w["labels"][rows])
            assert np.array_equal(g["mask"], w["mask"][rows])
    with pytest.raises(ValueError, match="not divisible"):
        SyntheticLoader(4, world_size=3, **kw)
