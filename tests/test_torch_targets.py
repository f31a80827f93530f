"""The port's target builders (yolov5m_tpu_torch/train/targets.py) against
the JAX ones on the same numpy labels: every tensor must be EXACTLY equal.
The JAX functions run op by op (not jitted), so neither side fuses a
multiply and a subtract; the numpy golden of tests/loss_golden.py holds the
dense grid too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.loss_golden import golden_grid_targets
from yolov5m_tpu.config import ANCHORS
from yolov5m_tpu.train import targets as jt
from yolov5m_tpu_torch.train import targets as tt

torch.set_num_threads(1)

ANCHORS_PX = np.asarray(ANCHORS, np.float32)
NC = 7
GRIDS = {"square": [(16, 16), (8, 8), (4, 4)],
         "rect": [(12, 20), (6, 10), (3, 5)]}


def _labels(case, seed=0, bs=3, nb=12):
    rng = np.random.default_rng(seed)
    labels = np.zeros((bs, nb, 5), np.float32)
    mask = np.zeros((bs, nb), bool)
    if case == "empty":
        return labels, mask
    for b in range(bs):
        n = int(rng.integers(1, nb + 1)) if b != 1 else 0
        labels[b, :n, 0] = rng.integers(0, NC, n)
        labels[b, :n, 1:3] = rng.uniform(0.0, 1.0, (n, 2))
        labels[b, :n, 3:5] = rng.uniform(0.01, 0.6, (n, 2))
        mask[b, :n] = True
    if case == "edge":
        # boxes on the image edge: x or y exactly 1.0 or 0.0
        labels[0, :4, 1:3] = [[1.0, 0.5], [0.5, 1.0], [1.0, 1.0], [0.0, 0.0]]
        mask[0, :4] = True
    if case == "shared":
        # two boxes in one cell at every scale with the same best anchor
        # (deviation #3: the first in label order wins, the second gets no
        # positive there), and a third, identical to the first
        labels[2, :3] = [[1, 0.51, 0.52, 0.10, 0.12],
                         [2, 0.515, 0.525, 0.11, 0.12],
                         [3, 0.51, 0.52, 0.10, 0.12]]
        mask[2, :3] = True
    return labels, mask


def _np(x):
    return np.asarray(x)


CASES = ["random", "empty", "edge", "shared"]


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("case", CASES)
def test_dense_grid_targets_equal_jax(case, grid):
    labels, mask = _labels(case)
    want = jt.build_grid_targets(jnp.asarray(labels), jnp.asarray(mask),
                                 jnp.asarray(ANCHORS_PX), GRIDS[grid])
    got = tt.build_grid_targets(torch.from_numpy(labels),
                                torch.from_numpy(mask),
                                torch.from_numpy(ANCHORS_PX), GRIDS[grid])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), _np(w))


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("case", CASES)
def test_sparse_grid_targets_equal_jax(case, grid):
    labels, mask = _labels(case, seed=1)
    want = jt.build_sparse_grid_targets(
        jnp.asarray(labels), jnp.asarray(mask), jnp.asarray(ANCHORS_PX),
        GRIDS[grid])
    got = tt.build_sparse_grid_targets(
        torch.from_numpy(labels), torch.from_numpy(mask),
        torch.from_numpy(ANCHORS_PX), GRIDS[grid])
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), _np(w[k]), err_msg=k)


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("case", CASES)
def test_flat_targets_equal_jax(case, grid):
    labels, mask = _labels(case, seed=2)
    want = jt.build_flat_targets(jnp.asarray(labels), jnp.asarray(mask),
                                 jnp.asarray(ANCHORS_PX), GRIDS[grid])
    got = tt.build_flat_targets(torch.from_numpy(labels),
                                torch.from_numpy(mask),
                                torch.from_numpy(ANCHORS_PX), GRIDS[grid])
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), _np(w[k]), err_msg=k)


def test_shared_cell_keeps_deviation_3():
    """The second box in a shared (cell, best anchor) gets no positive."""
    labels, mask = _labels("shared")
    got = tt.build_sparse_grid_targets(
        torch.from_numpy(labels), torch.from_numpy(mask),
        torch.from_numpy(ANCHORS_PX), GRIDS["square"])
    nb = labels.shape[1]
    for scale in got:
        valid = scale["valid"].view(-1, nb)[2, :3].tolist()
        assert valid == [True, False, False]


def test_dense_grid_matches_numpy_golden():
    labels, mask = _labels("random", seed=4)
    per_image = [labels[b][mask[b]] for b in range(labels.shape[0])]
    grids = GRIDS["square"]
    got = tt.build_grid_targets(torch.from_numpy(labels),
                                torch.from_numpy(mask),
                                torch.from_numpy(ANCHORS_PX), grids)
    want = golden_grid_targets(per_image, ANCHORS_PX, grids)
    for g, e in zip(got, want):
        g = g.numpy()
        np.testing.assert_array_equal(g[..., 4], e[..., 4])
        pos = e[..., 4] == 1
        np.testing.assert_allclose(g[pos], e[pos], rtol=1e-5, atol=1e-6)


def test_anchor_iou_all_equals_jax():
    wh = np.random.default_rng(5).uniform(0, 0.7, (4, 9, 2)).astype(np.float32)
    want = jt.anchor_iou_all(jnp.asarray(wh), jnp.asarray(ANCHORS_PX))
    got = tt.anchor_iou_all(torch.from_numpy(wh), torch.from_numpy(ANCHORS_PX))
    np.testing.assert_array_equal(got.numpy(), _np(want))
