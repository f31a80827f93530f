"""The port's pipeline-parallel inference and training
(yolov5m_tpu_torch/parallel/pp.py) against the JAX functions
(``yolov5m_tpu/parallel/pp.py``) on the virtual 8-device CPU mesh, the
same weights (bridged by state_dict_from_flax) and the same numpy inputs;
the port's grids are ``["cpu"] * n``. The cases of tests/test_pp.py:

  * ``StagePlan``: the live sets, buf_len, the steps per stage and the
    module -> stage map equal to JAX's for S in {2, 4, 8} and the cuts
    (4, 8, 13); pack/unpack is exact;
  * the linearized program equals the port's monolithic forward exactly
    (eval and train, running statistics included) and JAX's program
    within 1e-4;
  * inference (4 stages, 2 micro-batches of 2) and DPxPP inference (2x4)
    against JAX's within 1e-5, JAX's bound;
  * one PP train step (S 4, M 2) against M sequential one-device steps
    of the port's Trainer at accumulate=M within 1e-5, JAX's bound for
    the same claim, and against JAX's PP step within 2.1e-3: the port and
    XLA compute the step differently, and Adam turns a near-zero
    gradient's f32 noise into +-lr (tests/test_torch_trainer.py);
  * remat: the same step with the model's remat, against the step
    without it (1e-4, JAX's bound) and against JAX's step.

DPxPP training is in tests/test_torch_pp_dp.py (a file of its own so that
its JAX compile runs beside this file's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parallel_common import (HW, KW, STATE_ATOL,
                                         assert_same_detections,
                                         assert_state_close,
                                         assert_trainers_close, fused_pair,
                                         images, init_variables, jax_model,
                                         port_pieces, train_pair, two_boxes)
from yolov5m_tpu.models.yolo import normalized_anchors as jnormalized_anchors
from yolov5m_tpu.parallel import make_dp_pp_mesh as jmake_dp_pp_mesh
from yolov5m_tpu.parallel import make_pp_infer_fn as jmake_pp_infer_fn
from yolov5m_tpu.parallel import make_pp_mesh as jmake_pp_mesh
from yolov5m_tpu.parallel import make_pp_train_step as jmake_pp_train_step
from yolov5m_tpu.parallel.pp import StagePlan as JStagePlan
from yolov5m_tpu.parallel.pp import _STEPS as JSTEPS
from yolov5m_tpu_torch.models.yolo import YOLOv5, normalized_anchors
from yolov5m_tpu_torch.parallel import (make_dp_pp_mesh, make_pp_infer_fn,
                                        make_pp_mesh, make_pp_train_step)
from yolov5m_tpu_torch.parallel.grid import (N_STEPS, STEPS, ReplicaOps,
                                             Weights)
from yolov5m_tpu_torch.parallel.pp import StagePlan
from yolov5m_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

MB, M = 2, 2


@pytest.mark.parametrize("n_stages,cuts", [(2, None), (4, None), (8, None),
                                           (4, (4, 8, 13))])
def test_stage_plan_equals_jax(n_stages, cuts):
    variables = init_variables()
    jplan = JStagePlan(jax_model(), variables, (MB, HW, HW, 3), n_stages, cuts)
    model = YOLOv5(first_out=8, nc=4, depth_mult=0.33)
    plan = StagePlan(model, (MB, HW, HW, 3), n_stages, cuts)
    assert plan.live == jplan.live
    assert plan.buf_len == jplan.buf_len
    assert plan.stage_steps == jplan.stage_steps
    assert {k.replace(".", "_"): v for k, v in plan.module_stage.items()} \
        == jplan.module_stage
    for name, shape in plan.value_shapes.items():      # NCHW and NHWC
        b, c, h, w = shape
        assert jplan.value_shapes[name] == (b, h, w, c), name
    if cuts == (4, 8, 13):                 # tests/test_pp.py's liveness
        assert plan.live == [["x4"], ["p3", "p4", "x8"],
                             ["p3", "s20", "s40"]]
        assert [len(s) for s in plan.stage_steps] == [4, 4, 5, 6]
        assert sum(len(s) for s in plan.stage_steps) == N_STEPS
        rng = np.random.default_rng(0)
        vals = {n: torch.from_numpy(rng.normal(size=plan.value_shapes[n])
                                    .astype(np.float32)).contiguous(
            memory_format=torch.channels_last) for n in plan.live[1]}
        buf = plan.pack(vals, 1)
        assert buf.shape == (MB, plan.buf_len) and buf.dtype == torch.float32
        back = plan.unpack(buf, 1)
        for n in plan.live[1]:
            assert torch.equal(back[n], vals[n])


def test_stage_plan_refuses_s2d_and_int8_and_bad_cuts():
    with pytest.raises(ValueError, match="s2d"):
        StagePlan(YOLOv5(first_out=8, nc=4, depth_mult=0.33, stem_s2d=True),
                  (1, 64, 64, 3), 2)
    with pytest.raises(ValueError, match="int8"):
        StagePlan(YOLOv5(first_out=8, nc=4, depth_mult=0.33, fused=True,
                         quant="block"), (1, 64, 64, 3), 2)
    with pytest.raises(ValueError, match="cuts"):
        StagePlan(YOLOv5(first_out=8, nc=4, depth_mult=0.33),
                  (1, 64, 64, 3), 3, cuts=(8, 4))


def test_program_matches_monolithic_forward():
    """The step program over one "cpu" replica is the model's forward op
    for op: equal outputs, and in training equal running statistics; and
    JAX's step program within 1e-4."""
    variables = init_variables()
    from tests.torch_parallel_common import sd_from_flax
    sd = sd_from_flax(variables["params"], variables["batch_stats"])
    x = images(2, seed=1)
    jmodel = jax_model()

    def run_all(m, xx):
        vals = {"x0": xx.astype(jnp.float32)}
        for name, _, _, fn in JSTEPS:
            vals[name] = fn(m, vals, False)
        return vals["out"]

    want = jax.device_get(jmodel.apply(variables, jnp.asarray(x),
                                       method=run_all))
    for train in (False, True):
        a = YOLOv5(first_out=8, nc=4, depth_mult=0.33)
        b = YOLOv5(first_out=8, nc=4, depth_mult=0.33)
        a.load_state_dict(sd)
        b.load_state_dict(sd)
        a.train(train)
        b.train(train)
        with torch.no_grad():
            mono = a(torch.from_numpy(x))
            ops = ReplicaOps(b, Weights(), train)
            staged = ops.run({"x0": [ops.prep(torch.from_numpy(x),
                                              torch.device("cpu"))]},
                             STEPS)["out"]
        for p, q in zip(mono, staged):
            assert torch.equal(p, q[0])
        for k, v in a.state_dict().items():
            assert torch.equal(v, b.state_dict()[k]), k
        if not train:
            for p, w in zip(mono, want):
                np.testing.assert_allclose(p.numpy(), w, rtol=1e-4,
                                           atol=1e-4)


@pytest.fixture(scope="module")
def fused():
    return fused_pair()


@pytest.mark.parametrize("n_data,mb", [(1, 2), (2, 1)])
def test_pp_infer_matches_jax(fused, n_data, mb):
    """4 stages, 2 micro-batches; with a data axis (2x4) every replica
    pipelines its rows: 2 micro-batches of 1 a replica."""
    jfused, variables, model = fused
    x = images(4, seed=5 + n_data)
    if n_data == 1:
        jmesh, mesh, axis = (jmake_pp_mesh(n_pipe=4),
                             make_pp_mesh(4, device="cpu"), None)
    else:
        jmesh, mesh, axis = (jmake_dp_pp_mesh(n_data=2, n_pipe=4),
                             make_dp_pp_mesh(2, 4, device="cpu"), "data")
    want = jax.device_get(jmake_pp_infer_fn(
        jfused, variables, jnormalized_anchors(), jmesh, microbatch=mb,
        num_microbatches=M, image_hw=(HW, HW), data_axis=axis, **KW)(
        jnp.asarray(x)))
    infer = make_pp_infer_fn(model, normalized_anchors(), mesh, mb, M,
                             image_hw=(HW, HW), data_axis=axis, **KW)
    got = infer(torch.from_numpy(x))
    assert_same_detections(got, want, 1e-5)
    with pytest.raises(ValueError, match="PP takes"):
        infer(torch.from_numpy(x[:2]))


def _tensors(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture(scope="module")
def pp_batch():
    labels, mask = two_boxes(M * MB)
    return images(M * MB, seed=9), labels, mask


@pytest.fixture(scope="module")
def jax_pp_state(pp_batch):
    """JAX's PP step (S 4, M 2, mb 2) from the shared initial state."""
    x, labels, mask = pp_batch
    jmodel, jloss, jopt, jstate = train_pair(MB)
    step = jmake_pp_train_step(jmodel, jloss, jopt, jmake_pp_mesh(n_pipe=4),
                               microbatch=MB, num_microbatches=M,
                               image_hw=(HW, HW))
    return jax.device_get(step(jstate, jnp.asarray(x), jnp.asarray(labels),
                               jnp.asarray(mask)))


def _pp_trainer(n_stages, remat=False):
    model, loss, opt = port_pieces(train_pair(MB)[3], MB, remat=remat)
    return make_pp_train_step(model, loss, opt,
                              make_pp_mesh(n_stages, device="cpu"),
                              microbatch=MB, num_microbatches=M,
                              image_hw=(HW, HW))


def test_pp_train_step_matches_sequential_accumulate(pp_batch, jax_pp_state):
    """One PP call (M 2 through S 4) against two sequential one-device
    steps at accumulate=2 (1e-5: the same arithmetic in the same order)
    and against JAX's PP step (the loss within 2e-5, the state within
    2.1e-3)."""
    x, labels, mask = pp_batch
    trainer = _pp_trainer(4)
    m = trainer.train_step(*_tensors(x, labels, mask))

    model, loss, opt = port_pieces(train_pair(MB)[3], MB)
    ref = Trainer(model, loss, opt, accumulate=M)
    losses = []
    for i in range(M):
        sl = slice(i * MB, (i + 1) * MB)
        rm = ref.train_step(*_tensors(x[sl], labels[sl], mask[sl]))
        losses.append(float(rm["loss"]))
    assert trainer.step == ref.step == M
    assert trainer.optimizer.param_groups[0]["count"] == 1
    assert_trainers_close(trainer, ref, atol=1e-5, rtol=1e-5)
    for k in ("exp_avg", "exp_avg_sq"):
        for p, q in zip(trainer.params, ref.params):
            torch.testing.assert_close(trainer.optimizer.state[p][k],
                                       ref.optimizer.state[q][k],
                                       rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), np.mean(losses), rtol=1e-6)

    jstate, jm = jax_pp_state
    assert int(jstate.step) == M
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=2e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-3)
    assert_state_close(trainer, jstate, STATE_ATOL)


def test_pp_train_composes_with_remat(pp_batch, jax_pp_state):
    """remat on (S 2): within 1e-4 of the step without it (JAX's bound for
    the same pair) and of JAX's step within 2.1e-3."""
    x, labels, mask = pp_batch
    plain, rem = _pp_trainer(2), _pp_trainer(2, remat=True)
    for t in (plain, rem):
        t.train_step(*_tensors(x, labels, mask))
    assert_trainers_close(rem, plain, atol=1e-4)
    assert_state_close(rem, jax_pp_state[0], STATE_ATOL)
