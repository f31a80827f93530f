"""The port's DPxPP training (yolov5m_tpu_torch/parallel/pp.py with a data
axis) against the JAX function (``make_pp_train_step`` on
``make_dp_pp_mesh``, the case of tests/test_pp.py with uneven box counts)
on the virtual 8-device CPU mesh, the same weights and inputs; the port's
grid is 2 x 4 "cpu" cells. Against JAX's step: the loss within 2e-5, the
state within 2.1e-3 (two differently computed programs; Adam's +-lr on
near-zero gradients). Against the DP semantics written out in the port
(each micro-batch's loss global over the replicas' rows, BN statistics
local, running buffers averaged, one update): within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.torch_parallel_common import (HW, STATE_ATOL, assert_state_close,
                                         assert_trainers_close, images,
                                         port_pieces, train_pair,
                                         uneven_boxes)
from yolov5m_tpu.parallel import make_dp_pp_mesh as jmake_dp_pp_mesh
from yolov5m_tpu.parallel import make_pp_train_step as jmake_pp_train_step
from yolov5m_tpu_torch.models.yolo import YOLOv5
from yolov5m_tpu_torch.parallel import make_dp_pp_mesh, make_pp_train_step
from yolov5m_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

MB, M = 2, 2


def _tensors(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_dp_pp_train_matches_jax_and_dp_semantics():
    """DPxPP, 2 replicas x 4 stages, M 2, mb 2 a replica, 1 to 7 boxes an
    image: against JAX's DPxPP step, and against the DP semantics written
    out: each micro-batch's loss global over the replicas' rows (one
    one-device forward a replica, num/den summed), running buffers
    averaged over the replicas."""
    n_data, n_stages = 2, 4
    n = M * n_data * MB
    rng = np.random.default_rng(3)
    x = images(n, seed=11)
    labels, mask = uneven_boxes(n, rng)
    jmodel, jloss, jopt, jstate = train_pair(n_data * MB)
    jstate, jm = jmake_pp_train_step(
        jmodel, jloss, jopt, jmake_dp_pp_mesh(n_data=n_data, n_pipe=n_stages),
        microbatch=MB, num_microbatches=M, image_hw=(HW, HW),
        data_axis="data")(jstate, jnp.asarray(x), jnp.asarray(labels),
                          jnp.asarray(mask))
    jstate = jax.device_get(jstate)

    model, loss, opt = port_pieces(train_pair(MB)[3], n_data * MB)
    trainer = make_pp_train_step(
        model, loss, opt, make_dp_pp_mesh(n_data, n_stages, device="cpu"),
        microbatch=MB, num_microbatches=M, image_hw=(HW, HW),
        data_axis="data")
    m = trainer.train_step(*_tensors(x, labels, mask))
    assert trainer.step == int(jstate.step) == M
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=2e-5)
    assert_state_close(trainer, jstate, STATE_ATOL)

    # the DP semantics: replicas' rows through one model each
    model, loss, opt = port_pieces(train_pair(MB)[3], n_data * MB)
    replicas = [YOLOv5(first_out=8, nc=4, depth_mult=0.33)
                for _ in range(n_data)]
    total = 0.0
    for i in range(M):
        nums = dens = None
        stats = []
        for d, rep in enumerate(replicas):
            rep.load_state_dict(model.state_dict())
            rep.train()
            rows = slice((i * n_data + d) * MB, (i * n_data + d + 1) * MB)
            # the replica's BN buffers, the master's parameters
            out = torch.func.functional_call(
                rep, dict(model.named_parameters()), (torch.from_numpy(x[rows]),))
            nd = loss.num_den(out, *_tensors(labels[rows], mask[rows]))
            nums = nd[0] if nums is None else {
                k: nums[k] + nd[0][k] for k in nums}
            dens = nd[1] if dens is None else {
                k: dens[k] + nd[1][k] for k in dens}
            stats.append({k: v for k, v in rep.state_dict().items()
                          if "running" in k})
        t, _ = loss.compose(nums, dens, n_data * MB)
        t.backward()
        total += float(t.detach())
        with torch.no_grad():
            sd = model.state_dict()
            for k in stats[0]:
                sd[k].copy_(sum(s[k] for s in stats) / n_data)
    ref = Trainer(model, loss, opt, accumulate=M)
    ref.step = M - 1                       # the update fires on this one
    gnorm = torch.linalg.vector_norm(torch.stack(
        [p.grad.norm() for p in ref.params]))
    ref.optimizer.step(grad_norm=gnorm)
    ref.step = M
    ref.update_ema(1)
    np.testing.assert_allclose(float(m["loss"]), total / M, rtol=1e-6)
    np.testing.assert_allclose(float(m["grad_norm"]), float(gnorm), rtol=1e-5)
    assert_trainers_close(trainer, ref, atol=1e-5, rtol=1e-5)
