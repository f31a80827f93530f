"""The port's decode and fused postprocess (yolov5m_tpu_torch/ops/decode.py,
postprocess.py: both gates and gate_density; ops/nms.py:nms_single)
against the JAX package's on the same raw logits.

Valid masks, classes and the order of the kept rows must be exactly equal.
Confidences and box coordinates may differ by the last ulps of
torch.sigmoid against jax.nn.sigmoid (different exp implementations):
within 1e-6 relative plus 1e-4 px absolute."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov5m_tpu.models.yolo import normalized_anchors
from yolov5m_tpu.ops.decode import decode_predictions as jax_decode
from yolov5m_tpu.ops import nms as jax_nms
from yolov5m_tpu.ops import postprocess as jax_post
from yolov5m_tpu.ops.postprocess import fused_detect as jax_fused
from yolov5m_tpu_torch.ops import nms, postprocess
from yolov5m_tpu_torch.ops.decode import decode_predictions, make_grid
from yolov5m_tpu_torch.ops.postprocess import fused_detect

torch.set_num_threads(1)

HW, NC = 128, 4


def _preds(seed, saturate=False, gate_open=0.08):
    """Raw logits per scale (bs, 3, ny, nx, 5+nc). A `gate_open` share of
    cells clear a 0.25 gate; with `saturate`, a cluster of overlapping
    same-class cells gets objectness logits of 30-40, which all round to
    conf 1.0 in f32."""
    rng = np.random.default_rng(seed)
    out = []
    for s in (8, 16, 32):
        n = HW // s
        p = rng.normal(0, 1.5, (2, 3, n, n, 5 + NC)).astype(np.float32)
        p[..., 4] = np.where(rng.uniform(size=p.shape[:-1]) < gate_open,
                             rng.uniform(-1, 4, p.shape[:-1]), -6)
        out.append(p)
    if saturate:
        p = out[0]
        p[:, :, 4:7, 4:7, 4] = rng.uniform(30, 40, (2, 3, 3, 3))
        p[:, :, 4:7, 4:7, 0:4] = 0.0
        p[:, :, 4:7, 4:7, 5] = 5.0
        p[0, 0, 5, 5, 4] = p[0, 0, 5, 6, 4]       # an exact tie, saturated
    return out


def _check(t_out, t_valid, j_out, j_valid):
    j_out, j_valid = np.asarray(j_out), np.asarray(j_valid)
    np.testing.assert_array_equal(t_valid.numpy(), j_valid)
    t_out = t_out.numpy()
    np.testing.assert_array_equal(t_out[..., 0], j_out[..., 0])
    np.testing.assert_allclose(t_out, j_out, rtol=1e-6, atol=1e-4)


def test_make_grid():
    g = make_grid(2, 3)
    assert g.shape == (2, 3, 2)
    assert g[1, 2].tolist() == [2.0, 1.0]


def test_decode_predictions_matches_jax():
    preds = _preds(0)
    anchors = normalized_anchors()
    want = np.asarray(jax_decode([jnp.asarray(p) for p in preds],
                                 jnp.asarray(anchors)))
    got = decode_predictions([torch.from_numpy(p) for p in preds], anchors)
    np.testing.assert_array_equal(got[..., 0].numpy(), want[..., 0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("saturate", (False, True))
def test_fused_detect_matches_jax(saturate, dtype):
    preds = _preds(1, saturate)
    kw = dict(conf_threshold=0.25, iou_threshold=0.45, max_detections=50,
              pre_nms_topk=128)
    jp = [jnp.asarray(p).astype(dtype) for p in preds]
    tp = [torch.from_numpy(p).to(getattr(torch, dtype)) for p in preds]
    j_out, j_valid = jax_fused(jp, jnp.asarray(normalized_anchors()), **kw)
    t_out, t_valid = fused_detect(tp, normalized_anchors(), **kw)
    assert int(t_valid.sum()) > 0
    _check(t_out, t_valid, j_out, j_valid)


def test_fused_detect_neg_inf_rows_and_backends():
    """Fewer survivors than K: the top-K tail is NEG_INF rows (valid False),
    in index order; every plain backend gives the same answer."""
    preds = _preds(2, gate_open=0.01)
    kw = dict(conf_threshold=0.25, iou_threshold=0.45, max_detections=20,
              pre_nms_topk=256)
    j_out, j_valid = jax_fused([jnp.asarray(p) for p in preds],
                               jnp.asarray(normalized_anchors()), **kw)
    tp = [torch.from_numpy(p) for p in preds]
    for backend in ("auto", "torch", "torch_loop"):
        t_out, t_valid = fused_detect(tp, normalized_anchors(),
                                      backend=backend, **kw)
        _check(t_out, t_valid, j_out, j_valid)
    assert 0 < int(t_valid.sum(1).max()) < 20


def test_fused_detect_empty():
    preds = _preds(3, gate_open=0.0)
    out, valid = fused_detect([torch.from_numpy(p) for p in preds],
                              normalized_anchors(), pre_nms_topk=64)
    assert out.shape == (2, 300, 6) and not valid.any()
    assert not out.any()


@pytest.mark.parametrize("gate_open", (0.01, 0.08))
def test_compact_gate_below_capacity_is_the_sort_gate_and_jax(gate_open):
    """At most K survivors an image: the compact gate's detections are
    bitwise the sort gate's, and JAX's compact gate's."""
    preds = [torch.from_numpy(p) for p in _preds(4, gate_open=gate_open)]
    kw = dict(conf_threshold=0.25, iou_threshold=0.45, max_detections=64,
              pre_nms_topk=256)
    survivors, _ = postprocess.gate_density(preds, normalized_anchors())
    assert 0 < int(survivors.max()) <= kw["pre_nms_topk"]
    s_out, s_valid = fused_detect(preds, normalized_anchors(), gate="sort",
                                  **kw)
    c_out, c_valid = fused_detect(preds, normalized_anchors(),
                                  gate="compact", **kw)
    a_out, a_valid = fused_detect(preds, normalized_anchors(), **kw)
    assert int(s_valid.sum()) > 0
    for out, valid in ((c_out, c_valid), (a_out, a_valid)):
        assert torch.equal(valid, s_valid) and torch.equal(out, s_out)
    j_out, j_valid = jax_fused([jnp.asarray(p.numpy()) for p in preds],
                               jnp.asarray(normalized_anchors()),
                               gate="compact", **kw)
    _check(c_out, c_valid, j_out, j_valid)


def test_compact_gate_above_capacity_equals_jax():
    """More survivors than K: both keep the K lowest-index survivors,
    score-sorted; the gate's outputs and the detections equal JAX's."""
    rng = np.random.default_rng(5)
    n, k = 64, 8
    scores = rng.uniform(0.1, 5.0, (3, n)).astype(np.float32)
    mask = rng.uniform(size=(3, n)) < 0.5
    gated = np.where(mask, scores, np.float32(nms.NEG_INF)).astype(np.float32)
    got = postprocess._gate_compact(torch.from_numpy(gated), k)
    want = jax_post._gate_compact(jnp.asarray(gated), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for b in range(3):
        assert set(got[1][b].tolist()) == set(np.flatnonzero(mask[b])[:k])
    assert bool(got[2].all())

    preds = [torch.from_numpy(p) for p in _preds(6, gate_open=0.3)]
    kw = dict(conf_threshold=0.25, iou_threshold=0.45, max_detections=16,
              pre_nms_topk=24)
    survivors, _ = postprocess.gate_density(preds, normalized_anchors())
    assert int(survivors.min()) > kw["pre_nms_topk"]
    t_out, t_valid = fused_detect(preds, normalized_anchors(),
                                  gate="compact", **kw)
    j_out, j_valid = jax_fused([jnp.asarray(p.numpy()) for p in preds],
                               jnp.asarray(normalized_anchors()),
                               gate="compact", **kw)
    _check(t_out, t_valid, j_out, j_valid)
    s_out, _ = fused_detect(preds, normalized_anchors(), gate="sort", **kw)
    assert not torch.equal(t_out, s_out)     # truncation, not the top K


def test_unknown_gate_raises():
    preds = [torch.from_numpy(p) for p in _preds(7)]
    with pytest.raises(ValueError, match="gate must be"):
        fused_detect(preds, normalized_anchors(), gate="topk")
    with pytest.raises(ValueError, match="gate must be"):
        postprocess.candidates(preds, normalized_anchors(), gate="Sort")


@pytest.mark.parametrize("conf", (0.1, 0.25, 0.6))
def test_gate_density_equals_jax(conf):
    preds = _preds(8)
    kw = dict(conf_threshold=conf, iou_threshold=0.45, max_detections=30,
              pre_nms_topk=128)
    surv, dets = postprocess.gate_density(
        [torch.from_numpy(p) for p in preds], normalized_anchors(), **kw)
    j_surv, j_dets = jax_post.gate_density(
        [jnp.asarray(p) for p in preds], jnp.asarray(normalized_anchors()),
        **kw)
    np.testing.assert_array_equal(surv.numpy(), np.asarray(j_surv))
    np.testing.assert_array_equal(dets.numpy(), np.asarray(j_dets))
    assert int(dets.sum()) > 0


def test_nms_single_equals_jax():
    rng = np.random.default_rng(9)
    n = 200
    cxy = rng.uniform(20, 100, (n, 2))
    wh = rng.uniform(5, 40, (n, 2))
    rows = np.concatenate([rng.integers(0, 3, (n, 1)),
                           rng.uniform(0, 1, (n, 1)), cxy, wh],
                          1).astype(np.float32)
    got_out, got_valid = nms.nms_single(torch.from_numpy(rows), 0.45, 0.25,
                                        max_detections=40, pre_nms_topk=128)
    want_out, want_valid = jax_nms.nms_single(jnp.asarray(rows), 0.45, 0.25,
                                              max_detections=40,
                                              pre_nms_topk=128)
    assert got_out.shape == (40, 6) and int(got_valid.sum()) > 0
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))
