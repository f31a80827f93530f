"""The port's trainer (yolov5m_tpu_torch/train/trainer.py) against the JAX
train step from the same initial weights (the JAX init, bridged with
state_dict_from_flax) on the same numpy batches, f32 on the CPU.

Tolerances. Adam divides each gradient by its own running RMS, so a
coordinate whose gradient is near zero can move by up to lr in either
direction on f32 reduction noise alone: params, BN statistics and the EMA
are held to the +-2*lr scale (atol 2.1e-3), the repo's bound for two
differently compiled programs; Adam's moments are held by norm, to 1e-3
after the first update and 2e-2 after N, as the gradient norm is (the
weights then differ by up to 2*lr: measured 4.7e-3 for the second moment
by step 3). After the first update, whose forwards saw identical weights, the
running variance of the deepest BatchNorm must match to 1e-5 relative:
torch's own BatchNorm2d update (unbiased variance) would miss it by
n/(n-1) - 1 = 1/7 of the batch term at P5 of this batch. The
optimizer chain alone, on the same gradients, is held to two f32 ulps of
each parameter (rtol 2.5e-7) plus 1e-6 of the update: the same
arithmetic up to rounding (measured: up to 2 ulps after four updates)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from yolov5m_tpu.config import ANCHORS
from yolov5m_tpu.config import Config as JConfig
from yolov5m_tpu.models import YOLOv5 as JYOLOv5
from yolov5m_tpu.train import LossConfig as JLossConfig
from yolov5m_tpu.train import YoloLoss as JYoloLoss
from yolov5m_tpu.train import trainer as jtr
from yolov5m_tpu_torch.config import Config
from yolov5m_tpu_torch.models.weights import state_dict_from_flax
from yolov5m_tpu_torch.models.yolo import YOLOv5
from yolov5m_tpu_torch.train.loss import LossConfig, YoloLoss
from yolov5m_tpu_torch.train.trainer import (Trainer, YoloAdam,
                                             accumulation_steps, ema_decay,
                                             make_lr_schedule)

torch.set_num_threads(1)

NC, HW, BS = 4, 64, 2
ANCHORS_PX = np.asarray(ANCHORS, np.float32)
ATOL = 2.1e-3
DEEPEST_BN = "neck.7.c_out.cbl.1.running_var"


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        image = rng.uniform(0, 1, (BS, HW, HW, 3)).astype(np.float32)
        labels = np.zeros((BS, 6, 5), np.float32)
        mask = np.zeros((BS, 6), bool)
        for b in range(BS):
            k = int(rng.integers(1, 6))
            labels[b, :k, 0] = rng.integers(0, NC, k)
            labels[b, :k, 1:3] = rng.uniform(0.1, 0.9, (k, 2))
            labels[b, :k, 3:5] = rng.uniform(0.05, 0.5, (k, 2))
            mask[b, :k] = True
        out.append((image, labels, mask))
    return out


def _sd(params, stats=None):
    tree = {"params": jax.tree.map(np.asarray, params)}
    if stats is not None:
        tree["batch_stats"] = jax.tree.map(np.asarray, stats)
    return state_dict_from_flax(tree)


def _both(accumulate, lr_schedule="constant", warmup_steps=0):
    jcfg = JConfig(first_out=8, nc=NC, image_size=HW, batch_size=BS,
                   compute_dtype="float32", lr_schedule=lr_schedule,
                   warmup_steps=warmup_steps)
    jmodel = JYOLOv5(first_out=8, nc=NC, depth_mult=0.33)
    jloss = JYoloLoss(JLossConfig(nc=NC, image_size=HW), ANCHORS_PX)
    jopt = jtr.make_optimizer(jcfg, total_steps=8)
    jstate = jax.jit(lambda rng: jtr.create_train_state(
        jmodel, jcfg, rng, (HW, HW), jopt))(jax.random.PRNGKey(0))
    jstep = jax.jit(jtr.make_train_step(jmodel, jloss, jopt, accumulate))

    cfg = Config(first_out=8, nc=NC, image_size=HW, batch_size=BS,
                 lr_schedule=lr_schedule, warmup_steps=warmup_steps)
    model = YOLOv5(first_out=8, nc=NC, depth_mult=0.33)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           _sd(jstate.params, jstate.batch_stats).items()},
                          strict=True)
    trainer = Trainer(model, YoloLoss(LossConfig(nc=NC, image_size=HW),
                                      ANCHORS_PX),
                      YoloAdam(model.parameters(), cfg, total_steps=8),
                      accumulate)
    return jstate, jstep, trainer


def _norm(tensors):
    return float(np.sqrt(sum(float((np.asarray(t, np.float64) ** 2).sum())
                             for t in tensors)))


def _compare(jstate, trainer, label, first):
    want = _sd(jstate.params, jstate.batch_stats)
    got = trainer.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=0, atol=ATOL,
                                   err_msg=f"{label}: {k}")
    if first:
        np.testing.assert_allclose(got[DEEPEST_BN].numpy(), want[DEEPEST_BN],
                                   rtol=1e-5,
                                   err_msg=f"{label}: deepest BN var")
    ema_want = _sd(jstate.ema_params)
    ema_got = trainer.eval_state_dict()
    for k, v in ema_want.items():
        np.testing.assert_allclose(ema_got[k].numpy(), v, rtol=0, atol=ATOL,
                                   err_msg=f"{label}: EMA {k}")
    adam = jstate.opt_state[2]
    names = [n for n, _ in trainer.model.named_parameters()]
    for moment, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
        jm = _sd(moment)
        st = trainer.optimizer.state
        tm = {n: st[p][key].numpy() for n, p in
              zip(names, trainer.model.parameters())}
        np.testing.assert_allclose(_norm(tm.values()), _norm(jm.values()),
                                   rtol=1e-3 if first else 2e-2,
                                   err_msg=f"{label}: {key}")
        if first:     # one update from identical weights: element-wise
            # too (measured 1.0e-4 and 4.0e-4 of the norm: f32 noise of the
            # BN backward)
            diff = _norm([tm[n] - jm[n] for n in names])
            assert diff <= 1e-3 * _norm(jm.values()), (label, key, diff)
    assert trainer.optimizer.param_groups[0]["count"] == int(adam.count)


@pytest.mark.parametrize("accumulate,steps", [(1, 3), (2, 4)])
def test_steps_match_jax(accumulate, steps):
    jstate, jstep, trainer = _both(accumulate)
    for i, (image, labels, mask) in enumerate(_batches(steps)):
        jstate, jm = jstep(jstate, jnp.asarray(image), jnp.asarray(labels),
                           jnp.asarray(mask))
        tm = trainer.train_step(torch.from_numpy(image),
                                torch.from_numpy(labels),
                                torch.from_numpy(mask))
        # the first micro-batch sees identical weights; later ones see
        # weights apart by up to +-2*lr, which moves the loss by about 1e-3
        # and the gradient norm by about 1e-2 of itself (measured 1.0e-3
        # and 4.1e-3 by step 3)
        for k in ("loss", "grad_norm", "box", "obj", "cls"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5 if i == 0 else 2e-2,
                                       err_msg=f"step {i}: {k}")
        if i + 1 == accumulate or i + 1 == steps:   # after 1 and N updates
            _compare(jstate, trainer, f"accumulate {accumulate} step {i + 1}",
                     first=i + 1 == accumulate)


def _trees(seed, scale):
    rng = np.random.default_rng(seed)
    shapes = [(16, 3, 3, 3), (16,), (5, 16, 1, 1)]
    params = [rng.normal(0, 0.1, s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(0, 1, s) * scale).astype(np.float32)
              for s in shapes] for _ in range(4)]
    return params, grads


@pytest.mark.parametrize("schedule,grad_scale", [
    ("constant", 1e-3), ("constant", 1e3), ("cosine", 1e3), ("cosine", 0.1)])
def test_optimizer_chain_matches_optax(schedule, grad_scale):
    """Four updates of YoloAdam against the JAX chain on the same grads;
    grad_scale 1e3 puts the global norm far above max_grad_norm (clip)."""
    params, grads = _trees(1, grad_scale)
    jcfg = JConfig(lr_schedule=schedule, warmup_steps=2, learning_rate=1e-2)
    cfg = Config(lr_schedule=schedule, warmup_steps=2, learning_rate=1e-2)
    tx = jtr.make_optimizer(jcfg, total_steps=6)
    jp = [jnp.asarray(p) for p in params]
    jst = tx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    opt = YoloAdam(tp, cfg, total_steps=6)
    for g in grads:
        upd, jst = tx.update([jnp.asarray(x) for x in g], jst, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        assert opt.step()
        for p, want, u in zip(tp, jp, upd):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                       rtol=2.5e-7,
                                       atol=1e-6 * np.abs(np.asarray(u)).max())


def test_guard_nonfinite_skips_and_gives_up_like_optax():
    params, grads = _trees(2, 1.0)
    jcfg = JConfig(guard_nonfinite=True)
    cfg = Config(guard_nonfinite=True)
    tx = jtr.make_optimizer(jcfg)
    jp = [jnp.asarray(p) for p in params]
    jst = tx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    opt = YoloAdam(tp, cfg)
    bad = [g.copy() for g in grads[0]]
    bad[1][3] = np.nan
    seq = [grads[0], bad, grads[1], bad, bad, grads[2]]
    for n, g in enumerate(seq):
        upd, jst = tx.update([jnp.asarray(x) for x in g], jst, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        applied = opt.step()
        assert applied == (g is not bad), n
        for p, want in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-9)
        assert opt.param_groups[0]["count"] == int(jst.inner_state[2].count)
        assert opt.param_groups[0]["notfinite"] == int(jst.notfinite_count)
    # past MAX_CONSECUTIVE_NONFINITE in a row, the update is applied
    opt.param_groups[0]["notfinite"] = 100
    for p, x in zip(tp, bad):
        p.grad = torch.from_numpy(x)
    assert opt.step()
    assert torch.isnan(tp[1]).any()


def test_trainer_guard_skips_a_nan_step_but_steps_ema():
    model = YOLOv5(first_out=8, nc=NC, depth_mult=0.33)
    cfg = Config(first_out=8, nc=NC, image_size=HW, guard_nonfinite=True)
    trainer = Trainer(model, YoloLoss(LossConfig(nc=NC, image_size=HW),
                                      ANCHORS_PX),
                      YoloAdam(model.parameters(), cfg))
    image, labels, mask = (torch.from_numpy(x) for x in _batches(1)[0])
    trainer.train_step(image, labels, mask)
    before = [p.detach().clone() for p in trainer.params]
    ema_before = [e.clone() for e in trainer.ema]
    stats_before = model.neck[7].c_out.cbl[1].running_var.clone()
    hook = trainer.params[0].register_hook(lambda g: g * float("nan"))
    metrics = trainer.train_step(image, labels, mask)
    hook.remove()
    assert not torch.isfinite(metrics["grad_norm"])
    assert trainer.optimizer.param_groups[0]["count"] == 1
    for p, b in zip(trainer.params, before):
        assert torch.equal(p.detach(), b)
    d = ema_decay(2)
    for e, eb, p in zip(trainer.ema, ema_before, trainer.params):
        torch.testing.assert_close(e, eb * d + p.detach() * (1 - d))
    assert not torch.equal(model.neck[7].c_out.cbl[1].running_var,
                           stats_before)
    assert all(p.grad is None for p in trainer.params)


def test_lr_schedule_equals_optax():
    """At counts 0, warmup-1, warmup, warmup+1, the end and beyond (optax
    computes in f32, the port in double: rtol 1e-6)."""
    for warmup in (0, 5):
        kw = dict(learning_rate=5e-4, lr_schedule="cosine",
                  warmup_steps=warmup, lr_final=0.01)
        want = jtr.make_lr_schedule(JConfig(**kw), total_steps=40)
        got = make_lr_schedule(Config(**kw), total_steps=40)
        for count in sorted({0, max(warmup - 1, 0), warmup, warmup + 1, 20,
                             40, 45}):
            np.testing.assert_allclose(got(count), float(want(count)),
                                       rtol=1e-6, err_msg=f"{warmup} {count}")
    assert make_lr_schedule(Config())(123) == Config().learning_rate
    with pytest.raises(ValueError):
        make_lr_schedule(Config(lr_schedule="cosine"))


def test_constant_state_resumes_under_cosine():
    """One update count drives both: a state saved under "constant"
    loads into a cosine optimizer, whose next lr is the schedule's value
    at that count (the JAX package grafts the count by hand)."""
    params, grads = _trees(3, 1.0)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    opt = YoloAdam(tp, Config())
    for g in grads[:3]:
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        opt.step()
    cos_cfg = dataclasses.replace(Config(), lr_schedule="cosine",
                                  warmup_steps=1)
    resumed = YoloAdam(tp, cos_cfg, total_steps=10)
    resumed.load_state_dict(opt.state_dict())
    assert resumed.param_groups[0]["count"] == 3
    seen = []
    resumed.schedule = lambda count, f=resumed.schedule: seen.append(count) or f(count)
    for p, x in zip(tp, grads[3]):
        p.grad = torch.from_numpy(x)
    resumed.step()
    assert seen == [3]
    assert resumed.param_groups[0]["count"] == 4


def test_accumulation_steps_and_ema_decay_match_jax():
    for bs in (1, 2, 16, 32, 64, 128):
        assert accumulation_steps(bs) == jtr.accumulation_steps(bs)
    # the port computes in double, optax in f32: equal to an f32 ulp of 1
    for t in (0, 1, 10, 2000, 10 ** 6):
        np.testing.assert_allclose(ema_decay(t),
                                   float(jtr._ema_decay(jnp.asarray(t))),
                                   rtol=0, atol=1.2e-7)
