"""The port's data-parallel trainer (yolov5m_tpu_torch/parallel/dp.py,
Trainer with a group, the global loss, sync-BN) on the CPU: two ranks over
gloo, each a subprocess (tests/torch_dp_worker.py, one thread each), against

  * JAX ``make_dp_train_step`` on ``make_mesh(2)`` from the same flax init
    (weights carried by ``state_dict_from_flax``), on the same global
    batch of 4 at 64 px, first_out 8: local BN with accumulate 1 and 2,
    sync-BN (``bn_axis="data"``) with accumulate 1, and the ultralytics
    loss with local BN. One update each, so every micro-batch sees the
    same weights on both sides. Loss and parts within rtol 1e-4,
    grad_norm within rtol 1e-3 (the psum double-count this guards is a
    clean factor 2), parameters and EMA within the +-2*lr bound
    (ROUND5_NOTES.md section 2: fresh Adam turns a near-zero gradient of
    either sign into a +-lr step), BN running statistics within 1e-5;
  * the port in one process on the global batch: DP with sync-BN is the
    same step (the bounds of tests/test_trainer_dp.py);
  * itself: the ranks' states stay bitwise equal, and remat leaves the
    sync-BN step as it was.

The guards of tests/test_parallel_guards.py (local_batch_slice, too few
devices, a partial topology) close the file.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from yolov5m_tpu.config import ANCHORS
from yolov5m_tpu.config import Config as JConfig
from yolov5m_tpu.models import YOLOv5 as JYOLOv5
from yolov5m_tpu.parallel import make_dp_train_step as jmake_dp_train_step
from yolov5m_tpu.parallel import make_mesh as jmake_mesh
from yolov5m_tpu.parallel import replicate_state as jreplicate_state
from yolov5m_tpu.parallel import shard_batch
from yolov5m_tpu.train import LossConfig as JLossConfig
from yolov5m_tpu.train import YoloLoss as JYoloLoss
from yolov5m_tpu.train import trainer as jtr
from yolov5m_tpu_torch.config import Config
from yolov5m_tpu_torch.models.weights import state_dict_from_flax
from yolov5m_tpu_torch.models.yolo import YOLOv5
from yolov5m_tpu_torch.parallel import dp
from yolov5m_tpu_torch.train.loss import LossConfig, YoloLoss
from yolov5m_tpu_torch.train.trainer import Trainer, YoloAdam

torch.set_num_threads(1)

NC, HW, BS, WORLD = 4, 64, 4, 2
ANCHORS_PX = np.asarray(ANCHORS, np.float32)
ATOL = 2.1e-3            # +-2*lr (5e-4) and float noise
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_dp_worker.py")
WORKER_TIMEOUT = 300
KEYS = ("loss", "grad_norm", "box", "obj", "cls")

# name -> (sync-BN, loss kind, accumulate); steps = accumulate (one update)
JAX_CASES = {"local_acc1": (False, "custom", 1),
             "local_acc2": (False, "custom", 2),
             "sync_acc1": (True, "custom", 1),
             "ultralytics_acc1": (False, "ultralytics", 1)}


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


def _jax_case(state0, batches, sync_bn, kind, accumulate):
    jcfg = JConfig(first_out=8, nc=NC, image_size=HW, batch_size=BS,
                   compute_dtype="float32")
    jmodel = JYOLOv5(first_out=8, nc=NC, depth_mult=0.33,
                     bn_axis="data" if sync_bn else None)
    jloss = JYoloLoss(JLossConfig(nc=NC, image_size=HW), ANCHORS_PX,
                      kind=kind)
    mesh = jmake_mesh(WORLD)
    step = jmake_dp_train_step(jmodel, jloss, jtr.make_optimizer(jcfg), mesh,
                               accumulate)
    state = jreplicate_state(state0, mesh)
    metrics = []
    for image, labels, mask in batches[:accumulate]:
        b = shard_batch({"image": image, "labels": labels, "mask": mask},
                        mesh)
        state, m = step(state, b["image"], b["labels"], b["mask"])
        metrics.append({k: float(m[k]) for k in KEYS})
    return {"metrics": metrics,
            "state": _sd(state.params, state.batch_stats),
            "ema": _sd(state.ema_params), "count": int(
                state.opt_state[2].count)}


def _single_process(sd, batches):
    """The port's plain Trainer on the global batch (the sync-BN case's
    reference)."""
    model = YOLOv5(first_out=8, nc=NC, depth_mult=0.33)
    model.load_state_dict(sd, strict=True)
    trainer = Trainer(model, YoloLoss(LossConfig(nc=NC, image_size=HW),
                                      ANCHORS_PX),
                      YoloAdam(model.parameters(),
                               Config(first_out=8, nc=NC, image_size=HW)))
    image, labels, mask = (torch.from_numpy(x) for x in batches[0])
    m = trainer.train_step(image, labels, mask)
    return {"metrics": [{k: float(v) for k, v in m.items()}],
            "state": model.state_dict()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results (started first, they run while JAX
    compiles), JAX's for each case, and the port on one process."""
    tmp = tmp_path_factory.mktemp("dp")
    jcfg = JConfig(first_out=8, nc=NC, image_size=HW, batch_size=BS,
                   compute_dtype="float32")
    jmodel = JYOLOv5(first_out=8, nc=NC, depth_mult=0.33)
    state0 = jax.jit(lambda rng: jtr.create_train_state(
        jmodel, jcfg, rng, (HW, HW), jtr.make_optimizer(jcfg)))(
            jax.random.PRNGKey(0))
    sd = {k: torch.from_numpy(v)
          for k, v in _sd(state0.params, state0.batch_stats).items()}
    batches = _batches(2)
    cases = [dict(name=n, sync_bn=s, kind=k, accumulate=a, steps=a)
             for n, (s, k, a) in JAX_CASES.items()]
    cases.append(dict(name="sync_remat", sync_bn=True, kind="custom",
                      accumulate=1, steps=1, remat=True))
    inp, out = str(tmp / "in.pt"), str(tmp / "out")
    torch.save({"state_dict": sd, "nc": NC, "hw": HW, "cases": cases,
                "batches": [tuple(torch.from_numpy(x) for x in b)
                            for b in batches]}, inp)
    port = dp.free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD), str(port), inp, out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    try:
        want = {n: _jax_case(state0, batches, *spec)
                for n, spec in JAX_CASES.items()}
        single = _single_process(sd, batches)
        logs = [p.communicate(timeout=WORKER_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ranks = [torch.load(f"{out}.{r}", weights_only=False)
             for r in range(WORLD)]
    return {"ranks": ranks, "jax": want, "single": single}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_dp_step_matches_jax(runs, case):
    got, want = runs["ranks"][0][case], runs["jax"][case]
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for k in KEYS:
            np.testing.assert_allclose(
                g[k], w[k], rtol=1e-3 if k == "grad_norm" else 1e-4,
                err_msg=f"{case} micro-batch {i}: {k}")
    assert len(got["metrics"]) == len(want["metrics"])
    assert got["count"] == want["count"] == 1
    assert set(got["state"]) == set(want["state"])
    for k, v in want["state"].items():
        tol = 1e-5 if "running" in k else ATOL
        np.testing.assert_allclose(got["state"][k].numpy(), v, rtol=0,
                                   atol=tol, err_msg=f"{case}: {k}")
    for k, v in want["ema"].items():
        np.testing.assert_allclose(got["ema"][k].numpy(), v, rtol=0,
                                   atol=ATOL, err_msg=f"{case}: EMA {k}")


def test_sync_bn_dp_equals_one_process_on_the_global_batch(runs):
    """Sync-BN, the global loss and summed gradients make the two-rank
    step the single-process step on the global batch; a grad_norm doubled
    by a double-counted all-reduce fails the rtol 1e-3."""
    got, want = runs["ranks"][0]["sync_acc1"], runs["single"]
    np.testing.assert_allclose(got["metrics"][0]["grad_norm"],
                               want["metrics"][0]["grad_norm"], rtol=1e-3)
    np.testing.assert_allclose(got["metrics"][0]["loss"],
                               want["metrics"][0]["loss"], rtol=1e-4)
    flipped = total = 0
    for k, v in want["state"].items():
        a, b = got["state"][k].numpy(), v.numpy()
        if "running" in k:
            np.testing.assert_allclose(a, b, atol=1e-4, err_msg=k)
            continue
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=k)
        flipped += int((np.abs(a - b) > 1e-4).sum())
        total += a.size
    assert flipped / total < 0.01, f"{flipped}/{total} adam sign flips"


def test_ranks_stay_bitwise_equal(runs):
    r0, r1 = runs["ranks"]
    assert set(r0) == set(r1) == set(JAX_CASES) | {"sync_remat"}
    for case in r0:
        assert r0[case]["metrics"] == r1[case]["metrics"], case
        for part in ("state", "ema"):
            for k, v in r0[case][part].items():
                assert torch.equal(v, r1[case][part][k]), (case, part, k)


def test_sync_bn_remat_equals_no_remat(runs):
    """Under remat the recompute repeats sync-BN's collective but leaves
    the running statistics alone."""
    a, b = runs["ranks"][0]["sync_remat"], runs["ranks"][0]["sync_acc1"]
    for k in KEYS:
        np.testing.assert_allclose(a["metrics"][0][k], b["metrics"][0][k],
                                   rtol=1e-6, err_msg=k)
    for k, v in b["state"].items():
        np.testing.assert_allclose(a["state"][k].numpy(), v.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_local_batch_slice_guards():
    assert dp.local_batch_slice(64) == slice(0, 64)
    assert dp.local_batch_slice(64, rank=1, world_size=4) == slice(16, 32)
    with pytest.raises(ValueError, match="not divisible"):
        dp.local_batch_slice(64, world_size=3)


def test_make_mesh_never_truncates(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert dp.make_mesh(1) == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="requested a 2-device mesh"):
        dp.make_mesh(2)
    assert dp.make_mesh(2, "cpu") == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="requested"):
        dp.make_mesh(10 ** 6, "cpu")


def test_initialize_multihost_rejects_partial_topology():
    for kw in (dict(num_processes=2), dict(process_id=0),
               dict(coordinator_address="127.0.0.1:1", num_processes=2)):
        with pytest.raises(ValueError, match="coordinator_address"):
            dp.initialize_multihost(backend="gloo", **kw)
