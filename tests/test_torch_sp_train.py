"""The port's spatially partitioned training (yolov5m_tpu_torch/parallel/
sp.py) against the JAX functions on the virtual 8-device CPU mesh, the
same weights and inputs, grids of "cpu" cells; tests/test_sp_train.py's
two longer cases with its tolerances:

  * three steps at accumulate 2 on the 2x2 grid: loss rtol 5e-2, state
    2e-2 (two trajectories apart by +-lr after the first update);
  * float64: the train-mode gradients of the partitioned forward within
    1e-3 of JAX's partitioned ones, their norm within 1e-4, the loss
    within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tests.torch_parallel_common import (ANCHORS_PX, HW, NC,
                                         assert_state_close, images,
                                         init_variables, jax_model,
                                         port_pieces, sd_from_flax,
                                         train_pair, two_boxes)
from yolov5m_tpu.parallel import make_sp_mesh as jmake_sp_mesh
from yolov5m_tpu.parallel import make_sp_train_step as jmake_sp_train_step
from yolov5m_tpu.train import LossConfig as JLossConfig
from yolov5m_tpu.train import YoloLoss as JYoloLoss
from yolov5m_tpu_torch.models.yolo import YOLOv5
from yolov5m_tpu_torch.parallel import make_sp_mesh, make_sp_train_step
from yolov5m_tpu_torch.parallel.sp import sp_forward
from yolov5m_tpu_torch.train.loss import LossConfig, YoloLoss

torch.set_num_threads(1)


def _batch(bs, seed):
    labels, mask = two_boxes(bs)
    return images(bs, seed), labels, mask


def test_sp_train_multi_step_and_accumulate():
    """3 steps at accumulate 2 on the 2x2 grid: the BN statistics, the
    gated update and the EMA follow JAX's run (tests/test_sp_train.py's
    trajectory bounds)."""
    bs = 2
    jmodel, jloss, jopt, jstate = train_pair(bs)
    model, loss, opt = port_pieces(jstate, bs)
    jstep = jmake_sp_train_step(jmodel, jloss, jopt,
                                jmake_sp_mesh(n_data=2, n_spatial=2),
                                accumulate=2)
    trainer = make_sp_train_step(model, loss, opt,
                                 make_sp_mesh(2, 2, device="cpu"),
                                 accumulate=2)
    for i in range(3):
        x, labels, mask = _batch(bs, seed=100 + i)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(labels),
                           jnp.asarray(mask))
        m = trainer.train_step(torch.from_numpy(x), torch.from_numpy(labels),
                               torch.from_numpy(mask))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=5e-2)
        assert np.isfinite(float(m["loss"]))
    assert trainer.step == int(jax.device_get(jstate.step)) == 3
    assert trainer.optimizer.param_groups[0]["count"] == 1
    assert_state_close(trainer, jstate, 2e-2)


def test_sp_train_grads_exact_in_float64():
    """float64: the port's partitioned train-mode gradient against JAX's
    partitioned one (GSPMD on the (data, spatial) mesh), both on the same
    f64 weights and batch."""
    bs = 4
    x, labels, mask = _batch(bs, seed=7)
    entry_x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        # the f32 init cast to f64, as tests/test_sp_train.py does
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

        jmesh = jmake_sp_mesh(n_data=2, n_spatial=2)
        repl = NamedSharding(jmesh, P())
        img_s = NamedSharding(jmesh, P("data", "spatial"))
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
    preds = sp_forward(model, make_sp_mesh(2, 2, device="cpu"),
                       torch.from_numpy(x).double())
    total, _ = loss(preds, torch.from_numpy(labels), torch.from_numpy(mask))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), jl, atol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                for g in grads.values())))
    np.testing.assert_allclose(norm, jnorm, rtol=1e-4)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=1e-3,
                                   rtol=1e-3, err_msg=k)
