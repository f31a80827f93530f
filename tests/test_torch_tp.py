"""The port's tensor-parallel inference and training
(yolov5m_tpu_torch/parallel/tp.py) against the JAX functions
(``yolov5m_tpu/parallel/tp.py``) on the virtual 8-device CPU mesh, the
same weights (bridged by state_dict_from_flax) and the same numpy inputs;
the port's grids are ``["cpu"] * n``. The cases of tests/test_tp.py, with
its tolerances (detections within 1e-4; after one train step the loss
within 2e-5, params, EMA and BN buffers within 2.1e-3), and:

  * ``variable_pspec`` equal to JAX's on every leaf of the model at
    n_model 2, 3 and 4, the OIHW spec being JAX's HWIO one transposed;
  * inference at n_model 2, 4 and 8 (widths 8 to 128 split two to eight
    ways: the gathers must put the channels back in order before C3's and
    the SPPF's concats) and at 3, where the head's 27 channels shard;
  * the train step's gradient norm against the port's one-device step
    (a gradient counted once per device would be a clean n-fold) on the
    2x4 grid, and on 1x2 (head replicated, computed once) and 1x3 (head
    sharded).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parallel_common import (HW, KW, STATE_ATOL,
                                         assert_same_detections,
                                         assert_state_close, fused_pair,
                                         images, init_variables, port_pieces,
                                         train_pair, two_boxes)
from yolov5m_tpu.models.yolo import normalized_anchors as jnormalized_anchors
from yolov5m_tpu.parallel import make_tp_infer_fn as jmake_tp_infer_fn
from yolov5m_tpu.parallel import make_tp_mesh as jmake_tp_mesh
from yolov5m_tpu.parallel import make_tp_train_step as jmake_tp_train_step
from yolov5m_tpu.parallel.tp import variable_pspec as jvariable_pspec
from yolov5m_tpu_torch.models.weights import _flatten, torch_key_for_path
from yolov5m_tpu_torch.models.yolo import YOLOv5, normalized_anchors
from yolov5m_tpu_torch.ops.postprocess import fused_detect
from yolov5m_tpu_torch.parallel import (make_tp_infer_fn, make_tp_mesh,
                                        make_tp_train_step, shard_state_tp,
                                        shard_variables_tp)
from yolov5m_tpu_torch.parallel.tp import variable_pspec
from yolov5m_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)


def _transposed(jspec, ndim):
    """A JAX spec on an HWIO kernel as the spec on its OIHW twin."""
    spec = tuple(jspec)
    if ndim == 4 and spec:
        spec = spec + (None,) * (4 - len(spec))
        return (spec[3], spec[2], spec[0], spec[1])
    return spec


@pytest.mark.parametrize("hwio,oihw,want", [
    ((3, 3, 8, 16), (16, 8, 3, 3), ("model", None, None, None)),
    ((1, 1, 64, 27), (27, 64, 1, 1), ()),     # the head at nc 4
    ((16,), (16,), ("model",)),
    ((27,), (27,), ()),
    ((), (), ()),
])
def test_variable_pspec_rule(hwio, oihw, want):
    """tests/test_tp.py's leaves at n_model 4: conv kernels shard on O,
    per-channel vectors on dim 0, odd widths and scalars replicate."""
    jspec = jvariable_pspec(jnp.zeros(hwio), 4, "model")
    assert variable_pspec(torch.zeros(oihw), 4) == want
    assert _transposed(jspec, len(hwio)) == want
    assert variable_pspec(3, 4) == () == tuple(jvariable_pspec(3, 4, "model"))


@pytest.mark.parametrize("n_model", [2, 3, 4])
def test_variable_pspec_equals_jax_on_every_leaf(n_model):
    variables = init_variables()
    sd = YOLOv5(first_out=8, nc=4, depth_mult=0.33).state_dict()
    seen = 0
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables[collection]):
            key = torch_key_for_path(collection, path)
            want = _transposed(jvariable_pspec(leaf, n_model, "model"),
                               np.ndim(leaf))
            assert variable_pspec(sd[key], n_model) == want, key
            seen += 1
    assert seen == len(sd)


@pytest.fixture(scope="module")
def fused():
    return fused_pair()


# (n_data, n_model, bs): JAX's 2x4 and bs-1 1x8 cases, n_model 2, and 3,
# where the head (27 channels) shards
GRIDS = [(2, 4, 4), (1, 8, 1), (1, 2, 2), (1, 3, 2)]


@pytest.mark.parametrize("n_data,n_model,bs", GRIDS)
def test_tp_infer_matches_jax(fused, n_data, n_model, bs):
    jfused, variables, model = fused
    x = images(bs, seed=n_model)
    data_axis = "data" if n_data > 1 else None
    want = jax.device_get(jmake_tp_infer_fn(
        jfused, variables, jnormalized_anchors(),
        jmake_tp_mesh(n_data=n_data, n_model=n_model), data_axis=data_axis,
        **KW)(x))
    got = make_tp_infer_fn(model, normalized_anchors(),
                           make_tp_mesh(n_data, n_model, device="cpu"),
                           data_axis=data_axis, **KW)(torch.from_numpy(x))
    assert_same_detections(got, want, 1e-4)


def test_tp_output_on_the_first_device_and_uint8_ingress(fused):
    """JAX's output lies over all 8 devices of the 2x4 mesh; the port's on
    the grid's first one, in batch order, equal to JAX's and to the
    port's one-device pipeline; uint8 frames normalized inside give the
    same detections as the frames normalized before."""
    jfused, variables, model = fused
    frames = np.random.default_rng(5).integers(0, 256, (2, HW, HW, 3),
                                               np.uint8)
    x = frames.astype(np.float32) / np.float32(255)
    jdet, jvalid = jmake_tp_infer_fn(jfused, variables, jnormalized_anchors(),
                                     jmake_tp_mesh(n_data=2, n_model=4),
                                     **KW)(x)
    assert len(jdet.sharding.device_set) == 8
    mesh = make_tp_mesh(2, 4, device="cpu")
    det, valid = make_tp_infer_fn(model, normalized_anchors(), mesh,
                                  uint8_ingress=True, **KW)(
        torch.from_numpy(frames))
    assert det.device == mesh.devices[0, 0] and det.shape == (2, 32, 6)
    assert_same_detections((det, valid), jax.device_get((jdet, jvalid)),
                           1e-4)
    with torch.no_grad():
        one = fused_detect(model(torch.from_numpy(x)),
                           torch.from_numpy(normalized_anchors()), **KW)
    torch.testing.assert_close(det, one[0], rtol=1e-5, atol=1e-5)
    assert torch.equal(valid, one[1])


def _batch(bs, seed):
    labels, mask = two_boxes(bs)
    return images(bs, seed), labels, mask


def _one_device(bs, x, labels, mask):
    model, loss, opt = port_pieces(train_pair(bs)[3], bs)
    return Trainer(model, loss, opt).train_step(
        torch.from_numpy(x), torch.from_numpy(labels), torch.from_numpy(mask))


def test_tp_train_step_matches_jax():
    """One step on the (data 2, model 4) grid against JAX's TP step."""
    bs = 4
    jmodel, jloss, jopt, jstate = train_pair(bs)
    x, labels, mask = _batch(bs, seed=21)
    jstate, jm = jmake_tp_train_step(
        jmodel, jloss, jopt, jmake_tp_mesh(n_data=2, n_model=4))(
        jstate, jnp.asarray(x), jnp.asarray(labels), jnp.asarray(mask))
    model, loss, opt = port_pieces(train_pair(bs)[3], bs)
    trainer = make_tp_train_step(model, loss, opt,
                                 make_tp_mesh(2, 4, device="cpu"))
    m = trainer.train_step(torch.from_numpy(x), torch.from_numpy(labels),
                           torch.from_numpy(mask))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               atol=2e-5)
    assert_state_close(trainer, jstate, STATE_ATOL)
    one = _one_device(bs, x, labels, mask)
    np.testing.assert_allclose(float(m["grad_norm"]), float(one["grad_norm"]),
                               rtol=1e-3)


@pytest.mark.parametrize("n_model", [2, 3])
def test_tp_train_step_matches_one_device(n_model):
    """The head replicated (n_model 2) or sharded (3): loss and gradient
    norm of the one-device step, parameters within +-2*lr of it."""
    bs = 2
    x, labels, mask = _batch(bs, seed=30 + n_model)
    model, loss, opt = port_pieces(train_pair(bs)[3], bs)
    trainer = make_tp_train_step(model, loss, opt,
                                 make_tp_mesh(1, n_model, device="cpu"))
    m = trainer.train_step(torch.from_numpy(x), torch.from_numpy(labels),
                           torch.from_numpy(mask))
    ref_model, ref_loss, ref_opt = port_pieces(train_pair(bs)[3], bs)
    ref = Trainer(ref_model, ref_loss, ref_opt)
    one = ref.train_step(torch.from_numpy(x), torch.from_numpy(labels),
                         torch.from_numpy(mask))
    np.testing.assert_allclose(float(m["loss"]), float(one["loss"]),
                               atol=2e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(one["grad_norm"]),
                               rtol=1e-3)
    for k, v in ref.model.state_dict().items():
        torch.testing.assert_close(trainer.model.state_dict()[k], v,
                                   rtol=1e-4, atol=STATE_ATOL, msg=k)


def test_shard_variables_and_state_layout():
    """Leaf (d, m) of a sharded leaf is chunk m along dim 0 on device
    (d, m); a replicated leaf is whole on every device; a trainer's state
    places its parameters, EMA and Adam moments the same way."""
    mesh = make_tp_mesh(2, 4, device="cpu")
    model, loss, opt = port_pieces(train_pair(2)[3], 2)
    sd = model.state_dict()
    placed = shard_variables_tp(sd, mesh)
    w = "backbone.1.cbl.0.weight"                      # (16, 8, 3, 3)
    head = "head.out_convs.0.weight"                   # (27, 32, 1, 1)
    for d in range(2):
        for m in range(4):
            assert torch.equal(placed[w][d][m], sd[w][4 * m:4 * (m + 1)])
            assert torch.equal(placed[head][d][m], sd[head])
    trainer = make_tp_train_step(model, loss, opt, mesh)
    x, labels, mask = _batch(2, seed=40)
    trainer.train_step(torch.from_numpy(x), torch.from_numpy(labels),
                       torch.from_numpy(mask))
    state = shard_state_tp(trainer.state_dict(), mesh)
    names = [n for n, _ in model.named_parameters()]
    i = names.index(w)
    moment = trainer.optimizer.state_dict()["state"][i]["exp_avg"]
    got = state["optimizer"]["state"][i]["exp_avg"]
    assert torch.equal(got[1][2], moment[8:12])
    assert torch.equal(state["ema"][i][0][3], trainer.ema[i][12:16])
    assert state["step"] == 1


@pytest.mark.parametrize("scope", ["c3", "all"])
def test_tp_train_under_remat_equals_without(scope):
    bs = 2
    x, labels, mask = (torch.from_numpy(a) for a in _batch(bs, seed=51))
    states = []
    for remat in (False, True):
        model, loss, opt = port_pieces(train_pair(bs)[3], bs, remat=remat)
        model.remat_scope = scope
        trainer = make_tp_train_step(model, loss, opt,
                                     make_tp_mesh(2, 2, device="cpu"))
        trainer.train_step(x, labels, mask)
        states.append(trainer.model.state_dict())
    for k, v in states[0].items():
        assert torch.equal(v, states[1][k]), k
