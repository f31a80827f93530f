"""The port's train CLI (yolov5m_tpu_torch/cli/train.py) on the CPU, the
checkpoint module and the CSV logger.

  * --data synth runs epoch -> eval -> checkpoint -> --resume -> eval, as
    tests/test_e2e.py does for the JAX CLI;
  * a checkpoint saved under the constant lr resumes under cosine with the
    update count carried over;
  * every flag the port does not support yet raises SystemExit;
  * checkpoint round trip, latest_epoch, next_run_name, save_best,
    AsyncCheckpointer error surfacing; CSVLogger files byte-equal to the
    JAX logger's.
"""

import os

import numpy as np
import pytest
import torch

from yolov5m_tpu.utils import logging as jlogging
from yolov5m_tpu_torch.cli import train as cli
from yolov5m_tpu_torch.config import Config
from yolov5m_tpu_torch.models.yolo import YOLOv5
from yolov5m_tpu_torch.train.loss import LossConfig, YoloLoss
from yolov5m_tpu_torch.train.trainer import Trainer, YoloAdam
from yolov5m_tpu_torch.utils import checkpoint as ck
from yolov5m_tpu_torch.utils.logging import CSVLogger

torch.set_num_threads(1)

SMALL = ["--data", "synth", "--device", "cpu", "--nosaveimgs",
         "--first_out", "8", "--model", "n", "--image_size", "64",
         "--synth_val_batches", "1", "--filename", "model_1"]


def _lines(path):
    return path.read_text().strip().splitlines()


def test_synth_cycle_with_resume(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    args = SMALL + ["--bs", "2", "--synth_steps", "2", "--epochs", "1"]
    cli.main(cli.arg_parser(args))
    run = tmp_path / "SAVED_CHECKPOINT" / "model_1"
    logs = tmp_path / "train_eval_metrics" / "model_1"
    assert (run / "checkpoint_epoch_1.pt").is_file()
    assert (run / "checkpoint_best.pt").is_file()
    assert _lines(logs / "eval.csv")[0] == ",".join(jlogging.EVAL_HEADER)
    assert len(_lines(logs / "eval.csv")) == 2
    assert len(_lines(logs / "loss.csv")) == 2

    cli.main(cli.arg_parser(args + ["--resume"]))
    assert (run / "checkpoint_epoch_2.pt").is_file()
    assert len(_lines(logs / "eval.csv")) == 3
    state = ck.load_checkpoint("SAVED_CHECKPOINT", "model_1", 2)
    assert state["step"] == 4            # 2 micro-batches an epoch
    out = capsys.readouterr().out
    assert "resumed model_1 at epoch 1" in out and "MAP50:" in out


def test_constant_checkpoint_resumes_under_cosine(tmp_path, monkeypatch):
    """bs 32 accumulates 2 micro-batches: one optimizer update an epoch."""
    monkeypatch.chdir(tmp_path)
    args = SMALL + ["--bs", "32", "--synth_steps", "2", "--epochs", "1",
                    "--nosavelogs"]
    cli.main(cli.arg_parser(args))
    first = ck.load_checkpoint("SAVED_CHECKPOINT", "model_1", 1)
    assert first["optimizer"]["param_groups"][0]["count"] == 1
    cli.main(cli.arg_parser(args + ["--resume", "--lr_schedule", "cosine",
                                    "--warmup_epochs", "1"]))
    second = ck.load_checkpoint("SAVED_CHECKPOINT", "model_1", 2)
    assert second["optimizer"]["param_groups"][0]["count"] == 2
    moved = [not torch.equal(a, b) for a, b in
             zip(first["model"].values(), second["model"].values())]
    assert any(moved)


def test_only_eval_with_loaded_weights(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    torch.manual_seed(1)
    sd = YOLOv5(first_out=8, nc=80, depth_mult=0.33).state_dict()
    np.savez(tmp_path / "w.npz", **{k: v.numpy() for k, v in sd.items()})
    cli.main(cli.arg_parser(SMALL + ["--bs", "2", "--only_eval",
                                     "--load_coco_weights", "--weights",
                                     str(tmp_path / "w.npz"), "--epochs",
                                     "3"]))
    logs = tmp_path / "train_eval_metrics" / "model_1"
    assert len(_lines(logs / "eval.csv")) == 2       # one pass, then stop
    assert not (tmp_path / "SAVED_CHECKPOINT" / "model_1").exists()


REFUSED_ARGS = [["--data", "coco"], ["--rect"], ["--mosaic", "0.5"],
                ["--hsv"], ["--device_mosaic"], ["--device_augment"],
                ["--autoanchor"], ["--dp", "2"], ["--sp", "2"], ["--tp", "2"],
                ["--pp", "2"], ["--remat"], ["--flat_opt"]]


@pytest.mark.parametrize("extra", REFUSED_ARGS, ids=lambda a: a[0][2:])
def test_unsupported_flags_exit(extra, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="ROADMAP|JAX checkpoints"):
        cli.main(cli.arg_parser(SMALL + extra))
    assert not os.listdir(tmp_path)


def test_prediction_images_exit_without_nosaveimgs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = [a for a in SMALL if a != "--nosaveimgs"]
    with pytest.raises(SystemExit, match="matplotlib"):
        cli.main(cli.arg_parser(args))
    with pytest.raises(SystemExit, match="multiples of 32"):
        cli.main(cli.arg_parser(SMALL + ["--multi_scale", "48,64"]))


def _trainer(seed=0):
    torch.manual_seed(seed)
    model = YOLOv5(first_out=8, nc=3, depth_mult=0.33)
    cfg = Config(first_out=8, nc=3, image_size=64)
    return Trainer(model, YoloLoss(LossConfig(nc=3, image_size=64),
                                   np.zeros((3, 3, 2), np.float32) + 10),
                   YoloAdam(model.parameters(), cfg), accumulate=2)


def _step(trainer, seed):
    rng = np.random.default_rng(seed)
    image = torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    labels = torch.tensor([[[1, 0.5, 0.5, 0.2, 0.3]]] * 2, dtype=torch.float32)
    trainer.train_step(image, labels, torch.ones(2, 1, dtype=torch.bool))


def test_checkpoint_round_trip_is_exact(tmp_path):
    a = _trainer()
    for s in range(3):                   # ends mid-accumulation
        _step(a, s)
    path = ck.save_checkpoint(a.state_dict(), str(tmp_path), "model_3", 7)
    assert path.endswith("checkpoint_epoch_7.pt")
    assert ck.latest_epoch(str(tmp_path), "model_3") == 7
    b = _trainer(seed=5)
    b.load_state_dict(ck.load_checkpoint(str(tmp_path), "model_3", 7))
    _step(a, 9)
    _step(b, 9)
    for x, y in zip(a.params + a.ema, b.params + b.ema):
        assert torch.equal(x, y)
    assert a.optimizer.param_groups[0]["count"] == 2


def test_run_names_best_and_latest(tmp_path):
    root = str(tmp_path / "ckpt")
    assert ck.next_run_name(root) == "model_1"
    assert ck.latest_epoch(root, "model_1") is None
    os.makedirs(os.path.join(root, "model_2"))
    os.makedirs(os.path.join(root, "model_10"))
    os.makedirs(os.path.join(root, "other"))
    assert ck.next_run_name(root) == "model_11"
    state = {"w": torch.arange(3.0)}
    assert ck.save_best(state, root, "model_2", 1, 0.5) is not None
    assert ck.save_best(state, root, "model_2", 2, 0.4) is None
    assert ck.save_best(state, root, "model_2", 3, 0.6) is not None
    with open(os.path.join(root, "model_2", "best.txt")) as f:
        assert f.read().split() == ["3", "0.600000"]
    for e in (1, 12, 3):
        ck.save_checkpoint(state, root, "model_2", e)
    assert ck.latest_epoch(root, "model_2") == 12
    assert not any(n.endswith(".tmp")
                   for n in os.listdir(os.path.join(root, "model_2")))


def test_async_checkpointer_writes_and_surfaces_errors(tmp_path):
    saver = ck.AsyncCheckpointer()
    state = {"w": torch.ones(4), "n": 3, "g": [None, torch.zeros(2)]}
    saver.save(state, str(tmp_path), "model_1", 1, best_metric=0.25)
    state["w"].add_(1)                   # the snapshot was taken at save()
    saver.wait()
    got = ck.load_checkpoint(str(tmp_path), "model_1", 1)
    assert torch.equal(got["w"], torch.ones(4)) and got["n"] == 3
    assert got["g"][0] is None
    assert (tmp_path / "model_1" / "checkpoint_best.pt").is_file()
    (tmp_path / "blocked").write_text("a file where the run folder goes")
    saver.save(state, str(tmp_path), "blocked", 2)
    with pytest.raises(OSError):
        saver.wait()
    saver.wait()                         # the error is raised once


def test_csv_logger_equals_jax(tmp_path):
    for root, logger_cls in (("port", CSVLogger), ("jax", jlogging.CSVLogger)):
        lg = logger_cls(str(tmp_path / root), "run")
        lg.log_loss(1, 0, 0.12345, 0.5, 0.25)
        lg.log_eval(1, 0.123456, 0.98765, 0.5, 0.25)
        os.remove(os.path.join(lg.dir, "loss.csv"))
        lg = logger_cls(str(tmp_path / root), "run", resume=True)
        lg.log_eval(2, 0.5, 0.5, 0.75, 0.5)
        lg.log_loss(2, 100, 1.0, 2.0, 3.0)
    for name in ("loss.csv", "eval.csv"):
        assert ((tmp_path / "port" / "run" / name).read_bytes()
                == (tmp_path / "jax" / "run" / name).read_bytes())
