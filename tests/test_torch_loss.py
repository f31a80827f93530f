"""The port's YoloLoss (yolov5m_tpu_torch/train/loss.py) against the JAX
YoloLoss on the same numpy predictions and labels, f32 on the CPU.

Tolerance: the parts are sums over thousands of grid cells taken in a
different order on each side, so the total and the parts must agree to
rtol 2e-6, and every gradient with respect to the predictions to 2e-6 of
the largest gradient magnitude (f32 rounding of the reductions; measured
up to 5.3e-7 and 5.8e-7 over these cases). num_den/compose must give
exactly what __call__ gives."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov5m_tpu.config import ANCHORS
from yolov5m_tpu.train.loss import LossConfig as JLossConfig
from yolov5m_tpu.train.loss import YoloLoss as JYoloLoss
from yolov5m_tpu_torch.ops.boxes import box_iou
from yolov5m_tpu_torch.train.loss import (LossConfig, YoloLoss, bce_logits,
                                          focal_bce_logits)

torch.set_num_threads(1)

ANCHORS_PX = np.asarray(ANCHORS, np.float32)
HW = 96
PART_RTOL = 2e-6
GRAD_ATOL = 2e-6


def _inputs(seed, nc, bs=2, nb=10, zero_labels=False):
    rng = np.random.default_rng(seed)
    preds = [rng.normal(0, 1.5, (bs, 3, HW // s, HW // s, 5 + nc))
             .astype(np.float32) for s in (8, 16, 32)]
    labels = np.zeros((bs, nb, 5), np.float32)
    mask = np.zeros((bs, nb), bool)
    if not zero_labels:
        for b in range(bs):
            n = int(rng.integers(1, nb))
            labels[b, :n, 0] = rng.integers(0, nc, n)
            labels[b, :n, 1:3] = rng.uniform(0.02, 0.98, (n, 2))
            labels[b, :n, 3:5] = rng.uniform(0.02, 0.7, (n, 2))
            mask[b, :n] = True
        labels[0, 0, 1:3] = [1.0, 0.5]          # the edge box
    return preds, labels, mask


def _jax_loss(kind, lc_kw, preds, labels, mask):
    fn = JYoloLoss(JLossConfig(**lc_kw), ANCHORS_PX, kind=kind)

    def total_of(ps):
        return fn(ps, jnp.asarray(labels), jnp.asarray(mask))

    (total, parts), grads = jax.jit(jax.value_and_grad(
        total_of, has_aux=True))([jnp.asarray(p) for p in preds])
    return float(total), {k: float(v) for k, v in parts.items()}, \
        [np.asarray(g) for g in grads]


def _torch_loss(kind, lc_kw, preds, labels, mask):
    fn = YoloLoss(LossConfig(**lc_kw), ANCHORS_PX, kind=kind)
    ps = [torch.tensor(p, requires_grad=True) for p in preds]
    total, parts = fn(ps, torch.from_numpy(labels), torch.from_numpy(mask))
    total.backward()
    parts = {k: float(v.detach()) for k, v in parts.items()}
    return float(total.detach()), parts, [p.grad.numpy() for p in ps]


CASES = [
    ("custom", {"iou_type": "giou"}, {}),
    ("custom", {"iou_type": "ciou"}, {}),
    ("custom", {"iou_type": "diou"}, {}),
    ("custom", {"iou_type": "iou"}, {}),
    ("custom", {"label_smoothing": 0.1}, {}),
    ("custom", {"focal_gamma": 1.5}, {}),
    ("custom", {}, {"zero_labels": True}),
    ("ultralytics", {"iou_type": "giou"}, {}),
    ("ultralytics", {"iou_type": "ciou"}, {}),
    ("ultralytics", {"iou_type": "diou"}, {}),
    ("ultralytics", {"iou_type": "iou"}, {}),
    ("ultralytics", {"label_smoothing": 0.1, "focal_gamma": 2.0}, {}),
    ("ultralytics", {}, {"zero_labels": True}),
    ("ultralytics", {"nc": 1}, {}),
]


@pytest.mark.parametrize("kind,lc_kw,in_kw", CASES,
                         ids=[f"{k}-{'-'.join(f'{a}{b}' for a, b in {**lc, **i}.items()) or 'default'}"
                              for k, lc, i in CASES])
def test_loss_and_grads_match_jax(kind, lc_kw, in_kw):
    lc_kw = {"nc": 7, "image_size": HW, **lc_kw}
    inputs = _inputs(len(str(lc_kw)) + len(kind), lc_kw["nc"], **in_kw)
    jt, jparts, jgrads = _jax_loss(kind, lc_kw, *inputs)
    tt, tparts, tgrads = _torch_loss(kind, lc_kw, *inputs)
    assert np.isfinite(tt)
    np.testing.assert_allclose(tt, jt, rtol=PART_RTOL)
    for k in ("box", "obj", "cls"):
        np.testing.assert_allclose(tparts[k], jparts[k], rtol=PART_RTOL,
                                   atol=1e-12, err_msg=k)
    for g, jg in zip(tgrads, jgrads):
        scale = max(np.abs(jg).max(), 1e-30)
        np.testing.assert_allclose(g, jg, rtol=0, atol=GRAD_ATOL * scale)


@pytest.mark.parametrize("kind", ["custom", "ultralytics"])
def test_num_den_compose_equals_call(kind):
    preds, labels, mask = _inputs(7, 5)
    fn = YoloLoss(LossConfig(nc=5, image_size=HW), ANCHORS_PX, kind=kind)
    ps = [torch.from_numpy(p) for p in preds]
    lab, msk = torch.from_numpy(labels), torch.from_numpy(mask)
    total, parts = fn(ps, lab, msk)
    nums, dens = fn.num_den(ps, lab, msk)
    assert all(v.shape == (3,) for v in [*nums.values(), *dens.values()])
    total2, parts2 = fn.compose(nums, dens, preds[0].shape[0])
    assert torch.equal(total, total2)
    for k in parts:
        assert torch.equal(parts[k], parts2[k])


def test_bce_and_box_iou_match_jax():
    from yolov5m_tpu.ops.boxes import box_iou as jbox_iou
    from yolov5m_tpu.train.loss import bce_logits as jbce
    from yolov5m_tpu.train.loss import focal_bce_logits as jfocal

    rng = np.random.default_rng(3)
    x = rng.normal(0, 4, 1000).astype(np.float32)
    y = rng.uniform(0, 1, 1000).astype(np.float32)
    np.testing.assert_allclose(
        bce_logits(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(jbce(jnp.asarray(x), jnp.asarray(y))), rtol=1e-6,
        atol=1e-7)
    np.testing.assert_allclose(
        focal_bce_logits(torch.from_numpy(x), torch.from_numpy(y), 2.0).numpy(),
        np.asarray(jfocal(jnp.asarray(x), jnp.asarray(y), 2.0)), rtol=1e-5,
        atol=1e-7)
    b1 = np.concatenate([rng.uniform(0, 10, (500, 2)),
                         rng.uniform(0.5, 5, (500, 2))], 1).astype(np.float32)
    b2 = np.concatenate([rng.uniform(0, 10, (500, 2)),
                         rng.uniform(0.5, 5, (500, 2))], 1).astype(np.float32)
    for flags in ({}, {"giou": True}, {"diou": True}, {"ciou": True}):
        np.testing.assert_allclose(
            box_iou(torch.from_numpy(b1), torch.from_numpy(b2), **flags).numpy(),
            np.asarray(jbox_iou(jnp.asarray(b1), jnp.asarray(b2), **flags)),
            rtol=1e-5, atol=1e-6, err_msg=str(flags))
