"""The port's spatially partitioned inference and training
(yolov5m_tpu_torch/parallel/sp.py) against the JAX functions
(``yolov5m_tpu/parallel/sp.py``) on the virtual 8-device CPU mesh, the
same weights (bridged by state_dict_from_flax) and the same numpy inputs;
the port's grids are ``["cpu"] * n``. The cases of tests/test_sp_infer.py
and tests/test_sp_train.py, with their tolerances:

  * detections: valid masks equal, boxes and scores within 1e-4;
  * one train step: loss within 2e-5, params, EMA and BN buffers within
    2.1e-3 (+-2*lr, see tests/test_sp_train.py), on the 2x2 (data,
    spatial) grid and the pure 1x4 one;
  * the model's remat under the grid's forward changes nothing.

Three steps at accumulate 2 and the float64 gradients are in
tests/test_torch_sp_train.py (a file of its own so that its JAX compiles
run beside this file's).

128 px: P5 has 4 rows, 2 a shard on the 2x2 grid (the stride-2 halos,
1 above and 0 below, at shard edges) and 1 on the 1x4 grid (the SPPF's
2-row halos then reach two shards away). Heights whose rows split
unevenly, down to empty shards, are in tests/test_torch_sp_uneven.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from tests.torch_parallel_common import (HW, KW, STATE_ATOL,
                                         assert_same_detections,
                                         assert_state_close, cpu_grid,
                                         fused_pair, images, port_pieces,
                                         train_pair, two_boxes)
from yolov5m_tpu.models.yolo import normalized_anchors as jnormalized_anchors
from yolov5m_tpu.parallel import make_sp_infer_fn as jmake_sp_infer_fn
from yolov5m_tpu.parallel import make_sp_mesh as jmake_sp_mesh
from yolov5m_tpu.parallel import make_sp_train_step as jmake_sp_train_step
from yolov5m_tpu_torch.models.yolo import normalized_anchors
from yolov5m_tpu_torch.ops.postprocess import fused_detect
from yolov5m_tpu_torch.parallel import (make_sp_infer_fn, make_sp_mesh,
                                        make_sp_train_step)
from yolov5m_tpu_torch.parallel.mesh import Mesh
from yolov5m_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

# (n_data, n_spatial, bs): the 2-D grid, and the bs-1 latency case on a
# 1-D spatial mesh (JAX: Mesh(devices[:4], ("spatial",)))
GRIDS = [(2, 2, 4), (1, 4, 1)]


@pytest.fixture(scope="module")
def fused():
    return fused_pair()


def _meshes(n_data, n_spatial):
    if n_data == 1:
        return (JMesh(np.asarray(jax.devices()[:n_spatial]), ("spatial",)),
                Mesh(cpu_grid(n_spatial), ("spatial",)))
    return (jmake_sp_mesh(n_data=n_data, n_spatial=n_spatial),
            make_sp_mesh(n_data, n_spatial, device="cpu"))


@pytest.mark.parametrize("n_data,n_spatial,bs", GRIDS)
def test_sp_infer_matches_jax(fused, n_data, n_spatial, bs):
    jfused, variables, model = fused
    jmesh, mesh = _meshes(n_data, n_spatial)
    x = images(bs, seed=n_spatial)
    want = jax.device_get(jmake_sp_infer_fn(
        jfused, variables, jnormalized_anchors(), jmesh, **KW)(x))
    got = make_sp_infer_fn(model, normalized_anchors(), mesh, **KW)(
        torch.from_numpy(x))
    assert_same_detections(got, want, 1e-4)


def test_sp_output_on_the_first_device_in_batch_order(fused):
    """JAX returns detections batch-sharded over "data"; the port gathers
    them on the grid's first device in batch order: the JAX result, and
    row for row the port's one-device pipeline."""
    jfused, variables, model = fused
    x = images(2, seed=3)
    jmesh = jmake_sp_mesh(n_data=2, n_spatial=2)
    want_det, want_valid = jmake_sp_infer_fn(
        jfused, variables, jnormalized_anchors(), jmesh, **KW)(x)
    assert want_det.sharding.spec[0] == "data"
    mesh = make_sp_mesh(2, 2, device="cpu")
    det, valid = make_sp_infer_fn(model, normalized_anchors(), mesh, **KW)(
        torch.from_numpy(x))
    assert det.device == mesh.devices[0, 0] and det.shape == (2, 32, 6)
    assert valid.dtype == torch.bool
    assert_same_detections((det, valid), jax.device_get((want_det,
                                                         want_valid)), 1e-4)
    with torch.no_grad():
        one = fused_detect(model(torch.from_numpy(x)),
                           torch.from_numpy(normalized_anchors()), **KW)
    torch.testing.assert_close(det, one[0], rtol=1e-5, atol=1e-5)
    assert torch.equal(valid, one[1])


def test_sp_refuses_rows_that_do_not_split(fused):
    """As in JAX, SP needs H divisible by n_spatial only: 64 px over 4
    shards runs (P5's 2 rows split 1/1/0/0) and gives the one-device
    detections; 96 px over 5 shards and a batch the data axis does not
    divide are refused."""
    model = fused[2]
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    det, valid = make_sp_infer_fn(model, normalized_anchors(),
                                  make_sp_mesh(1, 4, device="cpu"), **KW)(x)
    with torch.no_grad():
        one = fused_detect(model(x), torch.from_numpy(normalized_anchors()),
                           **KW)
    torch.testing.assert_close(det, one[0], rtol=1e-5, atol=1e-5)
    assert torch.equal(valid, one[1])
    infer5 = make_sp_infer_fn(model, normalized_anchors(),
                              make_sp_mesh(1, 5, device="cpu"), **KW)
    with pytest.raises(ValueError, match="height divisible by 5"):
        infer5(torch.zeros(1, 96, 96, 3))
    with pytest.raises(ValueError, match="not a multiple"):
        make_sp_infer_fn(model, normalized_anchors(),
                         make_sp_mesh(2, 2, device="cpu"), **KW)(
            torch.zeros(3, HW, HW, 3))


def _batch(bs, seed):
    labels, mask = two_boxes(bs)
    return images(bs, seed), labels, mask


@pytest.mark.parametrize("n_data,n_spatial,bs", GRIDS)
def test_sp_train_step_matches_jax(n_data, n_spatial, bs):
    jmodel, jloss, jopt, jstate = train_pair(bs)
    x, labels, mask = _batch(bs, seed=10 + n_spatial)
    jmesh = jmake_sp_mesh(n_data=n_data, n_spatial=n_spatial)
    jstep = jmake_sp_train_step(jmodel, jloss, jopt, jmesh,
                                data_axis="data" if n_data > 1 else None)
    jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(labels),
                       jnp.asarray(mask))

    model, loss, opt = port_pieces(train_pair(bs)[3], bs)
    mesh = make_sp_mesh(n_data, n_spatial, device="cpu")
    trainer = make_sp_train_step(model, loss, opt, mesh,
                                 data_axis="data" if n_data > 1 else None)
    m = trainer.train_step(torch.from_numpy(x), torch.from_numpy(labels),
                           torch.from_numpy(mask))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               atol=2e-5)
    assert_state_close(trainer, jstate, STATE_ATOL)
    # the gradient's norm against the port's one-device step on the same
    # batch: a gradient counted once per shard would be a clean n-fold.
    # (JAX's partitioned f32 step reports a norm 35% off its own
    # one-device step's here, 10.05 against 15.49: the f32 noise of the
    # BN backward that tests/test_sp_train.py describes; the port's is
    # within 3e-5 of the one-device norm of both.)
    model, loss, opt = port_pieces(train_pair(bs)[3], bs)
    one = Trainer(model, loss, opt).train_step(
        torch.from_numpy(x), torch.from_numpy(labels), torch.from_numpy(mask))
    np.testing.assert_allclose(float(m["grad_norm"]), float(one["grad_norm"]),
                               rtol=1e-3)
    np.testing.assert_allclose(float(m["loss"]), float(one["loss"]),
                               atol=2e-5)


@pytest.mark.parametrize("scope", ["c3", "all"])
def test_sp_train_under_remat_equals_without(scope):
    """The model's remat under the grid's forward: the recompute neither
    changes the step nor moves the running statistics twice."""
    bs = 4
    x, labels, mask = (torch.from_numpy(a) for a in _batch(bs, seed=50))
    states = []
    for remat in (False, True):
        model, loss, opt = port_pieces(train_pair(bs)[3], bs, remat=remat)
        model.remat_scope = scope
        trainer = make_sp_train_step(model, loss, opt,
                                     make_sp_mesh(2, 2, device="cpu"))
        trainer.train_step(x, labels, mask)
        states.append(trainer.model.state_dict())
    for k, v in states[0].items():
        assert torch.equal(v, states[1][k]), k
