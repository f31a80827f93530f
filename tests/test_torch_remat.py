"""Remat in the port's model (YOLOv5(remat=True), torch.utils.checkpoint
over the C3 stacks, or every backbone and neck block with scope "all").

Remat must change memory and nothing else: the Trainer's gradients within
1e-6 of the run without remat (they come out equal), and the BatchNorm
running statistics EQUAL after one and after two steps, for both scopes:
the checkpointed recompute must not update them a second time. Also held
against the JAX package's remat model (nn.remat) on the same weights and
batch: training-mode outputs within 1e-4, each parameter's gradient
within 1e-3 of its largest entry (the stem's gradient crosses every
training-mode BatchNorm backward, where f32 sums taken in another order
cancel differently: measured 1.5e-4 of the largest entry), and the
running statistics after one step within 1e-5."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov5m_tpu.config import ANCHORS
from yolov5m_tpu.models import YOLOv5 as JYOLOv5
from yolov5m_tpu_torch.config import Config
from yolov5m_tpu_torch.models.weights import state_dict_from_flax
from yolov5m_tpu_torch.models.yolo import YOLOv5
from yolov5m_tpu_torch.train.loss import LossConfig, YoloLoss
from yolov5m_tpu_torch.train.trainer import Trainer, YoloAdam

torch.set_num_threads(1)

NC, HW, BS = 4, 64, 2


def _batch(seed):
    rng = np.random.default_rng(seed)
    image = rng.uniform(0, 1, (BS, HW, HW, 3)).astype(np.float32)
    labels = np.zeros((BS, 4, 5), np.float32)
    labels[:, :3, 0] = rng.integers(0, NC, (BS, 3))
    labels[:, :3, 1:3] = rng.uniform(0.2, 0.8, (BS, 3, 2))
    labels[:, :3, 3:5] = rng.uniform(0.1, 0.4, (BS, 3, 2))
    mask = np.zeros((BS, 4), bool)
    mask[:, :3] = True
    return [torch.from_numpy(a) for a in (image, labels, mask)]


def _trainer(model):
    cfg = Config(first_out=8, nc=NC, image_size=HW)
    return Trainer(model, YoloLoss(LossConfig(nc=NC, image_size=HW),
                                   np.asarray(ANCHORS, np.float32)),
                   YoloAdam(model.parameters(), cfg), accumulate=1)


@pytest.mark.parametrize("scope", ["c3", "all"])
def test_remat_trainer_matches_no_remat(scope):
    torch.manual_seed(0)
    base = YOLOv5(first_out=8, nc=NC, depth_mult=0.33)
    plain = _trainer(copy.deepcopy(base))
    remat_model = copy.deepcopy(base)
    remat_model.remat, remat_model.remat_scope = True, scope
    remat = _trainer(remat_model)
    for step in range(2):
        batch = _batch(step)
        # the gradients of this step, before the optimizer consumes them
        grads = []
        for tr in (plain, remat):
            tr.model.train()
            total, _ = tr.loss_fn(tr.model(batch[0]), *batch[1:])
            grads.append(torch.autograd.grad(total, tr.params))
        for a, b in zip(*grads):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                       atol=1e-6)
        # the statistics those two forwards moved, then one real step each
        for tr in (plain, remat):
            tr.train_step(*batch)
        sd0, sd1 = plain.model.state_dict(), remat.model.state_dict()
        for k in sd0:
            assert torch.equal(sd0[k], sd1[k]), (scope, step, k)


def test_remat_scope_is_checked():
    with pytest.raises(ValueError, match="remat_scope"):
        YOLOv5(first_out=8, nc=NC, remat=True, remat_scope="neck")


@pytest.mark.parametrize("scope", ["c3", "all"])
def test_remat_matches_jax_remat(scope):
    jmodel = JYOLOv5(first_out=8, nc=NC, depth_mult=0.33, remat=True,
                     remat_scope=scope)
    v = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                             jnp.zeros((1, HW, HW, 3), jnp.float32))
    model = YOLOv5(first_out=8, nc=NC, depth_mult=0.33, remat=True,
                   remat_scope=scope)
    model.load_state_dict({k: torch.from_numpy(a) for k, a in
                           state_dict_from_flax(jax.device_get(v)).items()})
    model.train()
    x = _batch(3)[0]

    def jloss(params):
        outs, upd = jmodel.apply({"params": params,
                                  "batch_stats": v["batch_stats"]},
                                 jnp.asarray(x.numpy()), train=True,
                                 mutable=["batch_stats"])
        return sum(jnp.sum(o ** 2) for o in outs), (outs, upd)

    (jl, (jouts, jupd)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(v["params"])
    outs = model(x)
    loss = sum((o ** 2).sum() for o in outs)
    loss.backward()
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                                   rtol=1e-4, atol=1e-4)
    want = state_dict_from_flax(jax.device_get(
        {"params": jgrads, "batch_stats": jupd["batch_stats"]}))
    for name, p in model.named_parameters():
        scale = max(float(np.abs(want[name]).max()), 1.0)
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=0,
                                   atol=1e-3 * scale, err_msg=name)
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
