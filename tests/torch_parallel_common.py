"""Shared set-up of tests/test_torch_{sp,tp,pp}.py: the JAX model and its
train state from a seed, the port's model and Trainer on the same weights
(bridged by ``state_dict_from_flax``), seeded batches, and the comparisons.
first_out 8, depth 0.33, nc 4, 128 px: P5 has 4 rows, 2 a shard over 2
row shards and 1 over 4."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from yolov5m_tpu.config import ANCHORS
from yolov5m_tpu.config import Config as JConfig
from yolov5m_tpu.models import YOLOv5 as JYOLOv5
from yolov5m_tpu.models.fuse import fold_batchnorm as jfold
from yolov5m_tpu.models.yolo import normalized_anchors as jnormalized_anchors
from yolov5m_tpu.ops.postprocess import fused_detect as jfused_detect
from yolov5m_tpu.train import LossConfig as JLossConfig
from yolov5m_tpu.train import YoloLoss as JYoloLoss
from yolov5m_tpu.train import trainer as jtr
from yolov5m_tpu_torch.config import Config
from yolov5m_tpu_torch.models.weights import state_dict_from_flax
from yolov5m_tpu_torch.models.yolo import YOLOv5, normalized_anchors
from yolov5m_tpu_torch.train.loss import LossConfig, YoloLoss
from yolov5m_tpu_torch.train.trainer import Trainer, YoloAdam

NC, HW, DEPTH = 4, 128, 0.33
ANCHORS_PX = np.asarray(ANCHORS, np.float32)
KW = dict(conf_threshold=0.01, iou_threshold=0.45, max_detections=32,
          pre_nms_topk=64)
# params, EMA and BN buffers after an update: Adam moves a coordinate
# whose gradient is near zero by up to lr either way on f32 noise, so
# two differently computed steps agree to +-2*lr (tests/test_sp_train.py)
STATE_ATOL = 2.1e-3


def sd_from_flax(params, stats=None) -> dict:
    tree = {"params": jax.tree.map(np.asarray, params)}
    if stats is not None:
        tree["batch_stats"] = jax.tree.map(np.asarray, stats)
    return {k: torch.from_numpy(v) for k, v in state_dict_from_flax(tree).items()}


def jax_model(remat: bool = False):
    return JYOLOv5(first_out=8, nc=NC, depth_mult=DEPTH, dtype=jnp.float32,
                   remat=remat)


@functools.lru_cache(maxsize=None)
def _init_state():
    """The JAX TrainState from PRNGKey(0), on the host: made once, so
    that every case of a file starts from the same weights for one trace
    and compile of the init."""
    jcfg = JConfig(first_out=8, nc=NC, image_size=HW, compute_dtype="float32")
    jmodel, jopt = jax_model(), jtr.make_optimizer(jcfg)
    return jax.device_get(jax.jit(lambda rng: jtr.create_train_state(
        jmodel, jcfg, rng, (HW, HW), jopt))(jax.random.PRNGKey(0)))


def init_variables() -> dict:
    state = _init_state()
    return {"params": state.params, "batch_stats": state.batch_stats}


def fused_pair():
    """(JAX fused model, its folded variables, the port's fused model on
    the same weights)."""
    variables = jfold(init_variables())
    model = YOLOv5(first_out=8, nc=NC, depth_mult=DEPTH, fused=True).eval()
    model.load_state_dict(sd_from_flax(variables["params"]), strict=True)
    return jax_model().clone(fused=True), variables, model


def images(bs: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        0, 1, (bs, HW, HW, 3)).astype(np.float32)


def two_boxes(bs: int):
    """JAX's parallel tests' labels: two boxes an image."""
    labels = np.zeros((bs, 8, 5), np.float32)
    labels[:, 0] = [1, 0.4, 0.6, 0.3, 0.2]
    labels[:, 1] = [2, 0.7, 0.3, 0.2, 0.4]
    mask = np.zeros((bs, 8), bool)
    mask[:, :2] = True
    return labels, mask


def uneven_boxes(n: int, rng):
    """1 to 7 random boxes an image (tests/test_pp.py's DPxPP batch)."""
    labels = np.zeros((n, 8, 5), np.float32)
    mask = np.zeros((n, 8), bool)
    for b in range(n):
        k = int(rng.integers(1, 8))
        labels[b, :k, 0] = rng.integers(0, NC, k)
        labels[b, :k, 1:3] = rng.uniform(0.2, 0.8, (k, 2))
        labels[b, :k, 3:5] = rng.uniform(0.05, 0.3, (k, 2))
        mask[b, :k] = True
    return labels, mask


def jax_single_detect(jfused, variables, x: np.ndarray):
    preds = jfused.apply(variables, jnp.asarray(x), train=False)
    return jax.device_get(jfused_detect(
        preds, jnp.asarray(jnormalized_anchors()), **KW))


def assert_same_detections(got, want, tol: float) -> None:
    det, valid = (np.asarray(t) for t in got)
    want_det, want_valid = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_allclose(det[valid], want_det[want_valid], rtol=tol,
                               atol=tol)
    assert want_valid.any(), "degenerate test: no detections survived"


def train_pair(bs: int, remat: bool = False):
    """(JAX model, JAX loss, optax chain, a fresh copy of the initial JAX
    TrainState, which a donating step may consume)."""
    jcfg = JConfig(first_out=8, nc=NC, image_size=HW, batch_size=bs,
                   compute_dtype="float32")
    jloss = JYoloLoss(JLossConfig(nc=NC, image_size=HW), ANCHORS_PX,
                      kind="custom")
    jstate = jax.tree.map(jnp.array, _init_state())
    return jax_model(remat), jloss, jtr.make_optimizer(jcfg), jstate


def port_pieces(jstate, bs: int, remat: bool = False, dtype=torch.float32):
    """The port's model (weights and BN buffers of ``jstate``), loss and
    optimizer."""
    model = YOLOv5(first_out=8, nc=NC, depth_mult=DEPTH, remat=remat,
                   compute_dtype=dtype)
    model.load_state_dict(sd_from_flax(jstate.params, jstate.batch_stats),
                          strict=True)
    model = model.to(dtype)
    loss = YoloLoss(LossConfig(nc=NC, image_size=HW), ANCHORS_PX)
    cfg = Config(first_out=8, nc=NC, image_size=HW, batch_size=bs)
    return model, loss, YoloAdam(model.parameters(), cfg)


def assert_state_close(trainer: Trainer, jstate, atol: float,
                       rtol: float = 1e-4) -> None:
    """Params, BN buffers and EMA of the port's trainer against a JAX
    TrainState (raw Adam moments are not compared element-wise: see
    tests/test_sp_train.py)."""
    want = sd_from_flax(jstate.params, jstate.batch_stats)
    got = trainer.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)
    ema = trainer.eval_state_dict()
    for k, v in sd_from_flax(jstate.ema_params).items():
        np.testing.assert_allclose(ema[k].numpy(), v.numpy(), rtol=rtol,
                                   atol=atol, err_msg=f"EMA {k}")


def assert_trainers_close(a: Trainer, b: Trainer, atol: float,
                          rtol: float = 0.0) -> None:
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=rtol, atol=atol,
                                   msg=k)
    for x, y in zip(a.ema, b.ema):
        torch.testing.assert_close(x, y, rtol=rtol, atol=atol)


def cpu_grid(n: int) -> list:
    return ["cpu"] * n


__all__ = ["ANCHORS_PX", "DEPTH", "HW", "KW", "NC", "STATE_ATOL",
           "assert_same_detections", "assert_state_close",
           "assert_trainers_close", "cpu_grid", "fused_pair", "images",
           "init_variables",
           "jax_model", "jax_single_detect", "normalized_anchors",
           "port_pieces", "sd_from_flax", "train_pair", "two_boxes",
           "uneven_boxes"]
