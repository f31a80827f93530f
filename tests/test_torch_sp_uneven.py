"""The port's SP (yolov5m_tpu_torch/parallel/sp.py) at heights whose rows
do not split evenly over the row shards, against the JAX functions
(``yolov5m_tpu/parallel/sp.py``) on the virtual 8-device CPU mesh and
against the port's one-device pipeline, the same weights (bridged by
state_dict_from_flax) and the same numpy inputs.

JAX's SP needs only H divisible by n_spatial; GSPMD splits every deeper
activation of h rows into ceil(h / n)-row shards, the last ones shorter
or empty. The cases (H, W, n_data, n_spatial) and P5's rows:

  * 96x128 over 1x2: 3 rows, 2/1;
  * 160x128 over 1x4: 5 rows, 2/2/1/0;
  * 64x64 over 1x4: 2 rows, 1/1/0/0 (two empty shards);
  * 128x128 over 1x8: 4 rows, four empty shards;
  * 192x128 over 2x4: 6 rows, 2/2/2/0 on each batch row.

An odd n_spatial adds no case: H % 32 == 0 and H % n == 0 already give
H % 32n == 0. Bounds:

  * inference: valid masks equal, detections within 1e-4 of JAX's SP,
    within 1e-5 of the port's one-device pipeline;
  * one f32 train step at 160 over 1x4 and 96 over 1x2 against JAX's
    one-device step on the global batch, with tests/test_torch_sp.py's
    bounds (loss within 2e-5, state within 2.1e-3, grad_norm within 1e-3
    of the port's one-device step). JAX's partitioned f32 step is not the
    reference here: at 96 over 1x2 its grad_norm is 39.0 against the
    one-device 66.3 (the f32 noise of the BN backward that
    tests/test_sp_train.py describes);
  * float64 at 160 over 1x4: the gradients of the port's partitioned
    forward against JAX's partitioned ones, with
    tests/test_torch_sp_train.py's bounds (loss 1e-5, norm 1e-4, each
    gradient 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from tests.torch_parallel_common import (ANCHORS_PX, HW, KW, NC, STATE_ATOL,
                                         assert_same_detections,
                                         assert_state_close, fused_pair,
                                         init_variables, jax_model,
                                         port_pieces, sd_from_flax,
                                         train_pair, two_boxes)
from yolov5m_tpu.models.yolo import normalized_anchors as jnormalized_anchors
from yolov5m_tpu.parallel import make_sp_infer_fn as jmake_sp_infer_fn
from yolov5m_tpu.parallel import make_sp_mesh as jmake_sp_mesh
from yolov5m_tpu.train import LossConfig as JLossConfig
from yolov5m_tpu.train import YoloLoss as JYoloLoss
from yolov5m_tpu.train import trainer as jtr
from yolov5m_tpu_torch.models.yolo import YOLOv5, normalized_anchors
from yolov5m_tpu_torch.ops.postprocess import fused_detect
from yolov5m_tpu_torch.parallel import make_sp_mesh, make_sp_train_step
from yolov5m_tpu_torch.parallel.mesh import Mesh
from yolov5m_tpu_torch.parallel.sp import (make_sp_infer_fn, sp_forward,
                                           split_rows)
from yolov5m_tpu_torch.train.loss import LossConfig, YoloLoss
from yolov5m_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

CASES = [(96, 128, 1, 2), (160, 128, 1, 4), (64, 64, 1, 4),
         (128, 128, 1, 8), (192, 128, 2, 4)]


def _images(bs, h, w, seed) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        0, 1, (bs, h, w, 3)).astype(np.float32)


def _meshes(n_data, n_spatial):
    if n_data == 1:
        return (JMesh(np.asarray(jax.devices()[:n_spatial]), ("spatial",)),
                Mesh(["cpu"] * n_spatial, ("spatial",)))
    return (jmake_sp_mesh(n_data=n_data, n_spatial=n_spatial),
            make_sp_mesh(n_data, n_spatial, device="cpu"))


@pytest.fixture(scope="module")
def fused():
    return fused_pair()


def test_split_rows_is_gspmds():
    """ceil(h / n) rows a shard, the last ones shorter or empty."""
    def split(h, n):
        return [split_rows(h, n, i) for i in range(n)]
    assert split(18, 4) == [(0, 5), (5, 10), (10, 15), (15, 18)]
    assert split(20, 8) == [(0, 3), (3, 6), (6, 9), (9, 12), (12, 15),
                            (15, 18), (18, 20), (20, 20)]
    assert split(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    assert split(8, 4) == [(0, 2), (2, 4), (4, 6), (6, 8)]


@pytest.mark.parametrize("h,w,n_data,n_spatial", CASES)
def test_sp_uneven_infer_matches_jax_and_one_device(fused, h, w, n_data,
                                                    n_spatial):
    jfused, variables, model = fused
    jmesh, mesh = _meshes(n_data, n_spatial)
    x = _images(2 * n_data, h, w, seed=h + n_spatial)
    want = jax.device_get(jmake_sp_infer_fn(
        jfused, variables, jnormalized_anchors(), jmesh, **KW)(x))
    got = make_sp_infer_fn(model, normalized_anchors(), mesh, **KW)(
        torch.from_numpy(x))
    assert_same_detections(got, want, 1e-4)
    with torch.no_grad():
        one = fused_detect(model(torch.from_numpy(x)),
                           torch.from_numpy(normalized_anchors()), **KW)
    torch.testing.assert_close(got[0], one[0], rtol=1e-5, atol=1e-5)
    assert torch.equal(got[1], one[1])


def _batch(bs, h, w, seed):
    labels, mask = two_boxes(bs)
    return _images(bs, h, w, seed), labels, mask


@pytest.mark.parametrize("h,n_spatial", [(160, 4), (96, 2)])
def test_sp_uneven_train_step_matches_one_device(h, n_spatial):
    bs, w = 2, 128
    x, labels, mask = _batch(bs, h, w, seed=60 + n_spatial)
    jmodel, jloss, jopt, jstate = train_pair(bs)
    jstate, jm = jax.jit(jtr.make_train_step(jmodel, jloss, jopt))(
        jstate, jnp.asarray(x), jnp.asarray(labels), jnp.asarray(mask))

    model, loss, opt = port_pieces(train_pair(bs)[3], bs)
    trainer = make_sp_train_step(model, loss, opt,
                                 Mesh(["cpu"] * n_spatial, ("spatial",)),
                                 data_axis=None)
    m = trainer.train_step(torch.from_numpy(x), torch.from_numpy(labels),
                           torch.from_numpy(mask))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               atol=2e-5)
    assert_state_close(trainer, jstate, STATE_ATOL)
    model, loss, opt = port_pieces(train_pair(bs)[3], bs)
    one = Trainer(model, loss, opt).train_step(
        torch.from_numpy(x), torch.from_numpy(labels), torch.from_numpy(mask))
    np.testing.assert_allclose(float(m["grad_norm"]), float(one["grad_norm"]),
                               rtol=1e-3)


def test_sp_uneven_grads_exact_in_float64():
    """float64 at 160 over 1x4 (P5's 5 rows 2/2/1/0): the port's
    partitioned train-mode gradient against JAX's partitioned one."""
    bs, h, w, n = 2, 160, 128, 4
    x, labels, mask = _batch(bs, h, w, seed=7)
    entry_x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        jmodel = jax_model().clone(dtype=jnp.float64)
        variables = init_variables()
        params = jax.tree.map(lambda t: jnp.asarray(t, jnp.float64),
                              variables["params"])
        stats = jax.tree.map(lambda t: jnp.asarray(t, jnp.float64),
                             variables["batch_stats"])
        jloss = JYoloLoss(JLossConfig(nc=NC, image_size=HW), ANCHORS_PX,
                          kind="custom")

        def loss_of(params, image):
            preds, _ = jmodel.apply({"params": params, "batch_stats": stats},
                                    image, train=True, mutable=["batch_stats"])
            return jloss(preds, jnp.asarray(labels), jnp.asarray(mask))[0]

        jmesh = JMesh(np.asarray(jax.devices()[:n]), ("spatial",))
        repl = NamedSharding(jmesh, P())
        img_s = NamedSharding(jmesh, P(None, "spatial"))
        jl, jg = jax.jit(jax.value_and_grad(loss_of),
                         in_shardings=(repl, img_s),
                         out_shardings=(repl, repl))(
            params, jnp.asarray(x, jnp.float64))
        jl = float(jl)
        jnorm = float(np.sqrt(sum(float((np.asarray(g) ** 2).sum())
                                  for g in jax.tree.leaves(jg))))
        want = sd_from_flax(jax.device_get(jg))
        sd = sd_from_flax(params, stats)
    finally:
        jax.config.update("jax_enable_x64", entry_x64)

    model = YOLOv5(first_out=8, nc=NC, depth_mult=jmodel.depth_mult,
                   compute_dtype=torch.float64)
    model.load_state_dict(sd, strict=True)
    model = model.double().train()
    loss = YoloLoss(LossConfig(nc=NC, image_size=HW), ANCHORS_PX)
    preds = sp_forward(model, Mesh(["cpu"] * n, ("spatial",)),
                       torch.from_numpy(x).double(), data_axis=None)
    assert [p.shape[2] for p in preds] == [h // 8, h // 16, h // 32]
    total, _ = loss(preds, torch.from_numpy(labels), torch.from_numpy(mask))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), jl, atol=1e-5)
    grads = {k: p.grad for k, p in model.named_parameters()}
    norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                for g in grads.values())))
    np.testing.assert_allclose(norm, jnorm, rtol=1e-4)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=1e-3,
                                   rtol=1e-3, err_msg=k)
