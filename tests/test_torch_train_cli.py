"""The port's train CLI (yolov5m_tpu_torch/cli/train.py) on the CPU, the
checkpoint module and the CSV logger.

  * --data synth runs epoch -> eval -> checkpoint -> --resume -> eval, as
    tests/test_e2e.py does for the JAX CLI;
  * a disk dataset (PPM, coco labels, data.yaml) runs the same cycle with
    device mosaic, device HSV/color jitter/flips, autoanchor (the refit
    saved to anchors.json and reloaded on --resume) and prediction images;
    --rect keeps the augmentation on the host;
  * a checkpoint saved under the constant lr resumes under cosine with the
    update count carried over;
  * the flags the port does not support yet raise SystemExit, and so does
    a run whose class names the prediction images cannot draw; the epoch
    images are written without matplotlib and equal the direct render;
  * the dataset resolution and data.yaml reading equal the JAX CLI's (with
    PyYAML and with the port's own reader), and the auto-remat rule;
  * checkpoint round trip, latest_epoch, next_run_name, save_best,
    AsyncCheckpointer error surfacing; CSVLogger files byte-equal to the
    JAX logger's.
"""

import argparse
import builtins
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.torch_datasets import write_dataset, write_thin_labels
from yolov5m_tpu.cli import train as jcli
from yolov5m_tpu.utils import logging as jlogging
from yolov5m_tpu_torch.cli import train as cli
from yolov5m_tpu_torch.config import Config
from yolov5m_tpu_torch.models.yolo import YOLOv5
from yolov5m_tpu_torch.train.loss import LossConfig, YoloLoss
from yolov5m_tpu_torch.train.trainer import Trainer, YoloAdam
from yolov5m_tpu_torch.utils import checkpoint as ck
from yolov5m_tpu_torch.utils.logging import CSVLogger

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


def test_dp_synth_epoch_then_resume_in_one_process(tmp_path, monkeypatch):
    """--dp 2 on the CPU: two gloo ranks train an epoch; rank 0 alone
    evaluates and writes one checkpoint (the single-process keys) and one
    eval row; a single process resumes it."""
    monkeypatch.chdir(tmp_path)
    args = SMALL + ["--bs", "4", "--synth_steps", "2", "--epochs", "1"]
    # its own session, so that a hang kills the spawned ranks too
    proc = subprocess.Popen(
        [sys.executable, "-m", "yolov5m_tpu_torch.cli.train", *args, "--dp",
         "2"], env={**os.environ, "PYTHONPATH": REPO}, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        start_new_session=True)
    try:
        log = proc.communicate(timeout=300)[0]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, log[-3000:]
    assert "data-parallel over 2 cpu devices" in log and "MAP50:" in log
    run = tmp_path / "SAVED_CHECKPOINT" / "model_1"
    logs = tmp_path / "train_eval_metrics" / "model_1"
    assert sorted(os.listdir(run)) == ["best.txt", "checkpoint_best.pt",
                                       "checkpoint_epoch_1.pt"]
    assert len(_lines(logs / "eval.csv")) == 2
    assert len(_lines(logs / "loss.csv")) == 2
    state = ck.load_checkpoint("SAVED_CHECKPOINT", "model_1", 1)
    assert state["step"] == 2
    single = YOLOv5(first_out=8, nc=80, depth_mult=0.33).state_dict()
    assert list(state["model"]) == list(single)
    cli.main(cli.arg_parser(args + ["--resume"]))
    assert (run / "checkpoint_epoch_2.pt").is_file()
    assert len(_lines(logs / "eval.csv")) == 3
    assert ck.load_checkpoint("SAVED_CHECKPOINT", "model_1", 2)["step"] == 4


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


# refused with --sp, --tp and --pp, where JAX fails too: 64 px rows over
# 3 shards (not divisible by 3), --tp with --sp (mutually exclusive), and
# 3 micro-batches of the default --bs 16
REFUSED_ARGS = [["--dp", "3"], ["--sp", "3"],
                ["--tp", "2", "--sp", "2"],
                ["--pp", "2", "--pp_micro", "3"], ["--flat_opt"],
                ["--autoanchor"]]


@pytest.mark.parametrize("extra", REFUSED_ARGS, ids=lambda a: a[0][2:])
def test_unsupported_flags_exit(extra, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # --dp 3 does not divide the default --bs 16 (or exceeds the cores)
    with pytest.raises(SystemExit, match="JAX checkpoints|disk dataset|not "
                                         "divisible|devices|mutually "
                                         "exclusive"):
        cli.main(cli.arg_parser(SMALL + extra))
    assert not os.listdir(tmp_path)


def test_no_flat_opt_is_a_hidden_no_op(capsys):
    """--no_flat_opt parses, as JAX's legacy flag does, changes no other
    option, passes check_supported and is left out of --help; --flat_opt
    stays refused (test_unsupported_flags_exit)."""
    opt = cli.arg_parser(SMALL + ["--no_flat_opt"])
    base = cli.arg_parser(SMALL)
    assert opt.no_flat_opt and not base.no_flat_opt
    assert {k: v for k, v in vars(opt).items() if k != "no_flat_opt"} == \
        {k: v for k, v in vars(base).items() if k != "no_flat_opt"}
    cli.check_supported(opt)
    with pytest.raises(SystemExit):
        cli.arg_parser(["--help"])
    assert "no_flat_opt" not in capsys.readouterr().out


@pytest.mark.parametrize("extra", [["--sp", "2"], ["--tp", "2"],
                                   ["--pp", "2"],
                                   ["--sp", "2", "--image_size", "96"]],
                         ids=["sp", "tp", "pp", "sp_96"])
def test_grid_training_on_the_cpu(extra, tmp_path, monkeypatch, capsys):
    """--sp, --tp and --pp train an epoch on a grid of "cpu" cells and
    write its eval row and checkpoint; the evaluator runs on the master
    parameters. At 96 px P5's 3 rows split 2/1 over the 2 row shards."""
    monkeypatch.chdir(tmp_path)
    cli.main(cli.arg_parser(SMALL + extra + ["--bs", "4", "--synth_steps",
                                             "1", "--epochs", "1"]))
    out = capsys.readouterr().out
    assert "grid" in out and "MAP50" in out
    logs = tmp_path / "train_eval_metrics" / "model_1"
    assert len(_lines(logs / "eval.csv")) == 2
    ckpt = ck.load_checkpoint("SAVED_CHECKPOINT", "model_1", 1)
    assert ckpt["step"] == (2 if extra[0] == "--pp" else 1)


class _Built(Exception):
    pass


@pytest.mark.parametrize("extra,per_epoch", [(["--pp", "2"], 4),
                                             (["--sp", "2"], 1)],
                         ids=["pp", "sp"])
def test_grid_schedule_horizon(extra, per_epoch, tmp_path, monkeypatch):
    """The cosine schedule's warmup and length count optimizer updates: PP
    updates once a loader batch (4 a synth epoch; the JAX CLI sets
    accumulate 1), SP once per nominal batch (bs 4 accumulates 16: one
    update an epoch)."""
    import yolov5m_tpu_torch.train.trainer as trainer_mod

    seen = {}

    class Recording(trainer_mod.YoloAdam):
        def __init__(self, params, cfg, total_steps=None):
            seen.update(warmup=cfg.warmup_steps, total=total_steps)
            raise _Built

    monkeypatch.setattr(trainer_mod, "YoloAdam", Recording)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(_Built):
        cli.main(cli.arg_parser(SMALL + extra + [
            "--bs", "4", "--synth_steps", "4", "--epochs", "2",
            "--lr_schedule", "cosine", "--warmup_epochs", "1"]))
    assert seen == {"warmup": per_epoch, "total": 2 * per_epoch}


def _without(monkeypatch, module):
    """Make ``import module`` fail, as on a machine without it."""
    real_import = builtins.__import__

    def fake(name, *args, **kwargs):
        if name.split(".")[0] == module:
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", fake)


def test_prediction_images_exit_without_nosaveimgs(tmp_path, monkeypatch):
    """Without --nosaveimgs, a class name the images cannot draw (here from
    data.yaml) stops the run before any work, naming the character."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="multiples of 32"):
        cli.main(cli.arg_parser(SMALL + ["--multi_scale", "48,64"]))
    root = _disk(tmp_path)
    with open(os.path.join(root, "data.yaml"), "w") as f:
        f.write("nc: 3\nnames: ['car', 'café', 'bike']\n")
    args = [a for a in DISK + ["--epochs", "1"]]
    with pytest.raises(SystemExit, match="'é'"):
        cli.main(cli.arg_parser(args))
    assert os.listdir(tmp_path) == ["datasets"]
    cli.main(cli.arg_parser(args + ["--nosaveimgs", "--nosavemodel",
                                    "--nosavelogs"]))


def test_epoch_images_without_matplotlib_equal_direct_render(tmp_path,
                                                             monkeypatch):
    """The default epoch images are written with matplotlib unimportable,
    and each equals the port's renderer called on the same inputs."""
    from tests.torch_plot_cases import decode
    from yolov5m_tpu_torch.utils import plotting

    monkeypatch.chdir(tmp_path)
    _without(monkeypatch, "matplotlib")
    seen = []
    real = plotting.save_prediction_images

    def spy(images, pred_rows, gt_rows, *args):
        seen.append((np.array(images), [np.array(r) for r in pred_rows],
                     [np.array(r) for r in gt_rows], args))
        return real(images, pred_rows, gt_rows, *args)

    monkeypatch.setattr(plotting, "save_prediction_images", spy)
    args = [a for a in SMALL if a != "--nosaveimgs"]
    cli.main(cli.arg_parser(args + ["--bs", "2", "--synth_steps", "1",
                                    "--epochs", "1", "--nosavemodel"]))
    saved = tmp_path / "SAVED_IMAGES" / "model_1" / "EPOCH_1"
    assert sorted(os.listdir(saved)) == ["image_0.png", "image_1.png"]
    (images, pred_rows, gt_rows, (_, _, _, labels, _)), = seen
    for i in range(2):
        want = plotting.render_prediction(images[i], pred_rows[i],
                                          gt_rows[i], labels)
        np.testing.assert_array_equal(decode(str(saved / f"image_{i}.png")),
                                      want)


YAML = "nc: 3  # three classes\nnames: ['car', \"person\",\n  bike]\n"
BLOCK_YAML = "names:\n  - car\n  - 'person'\n  - bike  # two wheels\nnc: 3\n"


def _disk(tmp_path, thin=False):
    root = write_dataset(str(tmp_path / "datasets" / "tiny"), "ppm",
                         n_train=8, n_val=3)
    if thin:
        write_thin_labels(root)
    with open(os.path.join(root, "data.yaml"), "w") as f:
        f.write(YAML)
    return root


DISK = ["--data", "tiny", "--device", "cpu", "--first_out", "8", "--model",
        "n", "--image_size", "64", "--bs", "2", "--max_boxes", "6",
        "--filename", "model_1", "--nw", "2"]


def test_disk_cycle_with_device_augment_autoanchor_and_resume(
        tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    _disk(tmp_path, thin=True)
    args = DISK + ["--epochs", "1", "--device_mosaic", "--mosaic", "0.5",
                   "--device_augment", "--hsv", "--autoanchor",
                   "--nosaveimgs"]
    cli.main(cli.arg_parser(args))
    run = tmp_path / "SAVED_CHECKPOINT" / "model_1"
    logs = tmp_path / "train_eval_metrics" / "model_1"
    out = capsys.readouterr().out
    assert "autoanchor: refit" in out and "4 train batches/epoch" in out
    with open(run / "anchors.json") as f:
        anchors = json.load(f)
    assert np.asarray(anchors).shape == (3, 3, 2)
    assert len(_lines(logs / "eval.csv")) == 2
    cli.main(cli.arg_parser(args + ["--resume"]))
    out = capsys.readouterr().out
    assert "loaded run anchors" in out and "resumed model_1 at epoch 1" in out
    with open(run / "anchors.json") as f:
        assert json.load(f) == anchors
    assert (run / "checkpoint_epoch_2.pt").is_file()
    assert len(_lines(logs / "eval.csv")) == 3
    state = ck.load_checkpoint("SAVED_CHECKPOINT", "model_1", 2)
    assert state["step"] == 8
    assert all(torch.isfinite(v).all() for v in state["model"].values())


def test_disk_rect_under_sp(tmp_path, monkeypatch, capsys):
    """--rect with --sp 2 trains an epoch on two "cpu" row shards, as in
    JAX: the rect batches' heights (multiples of 32, so of 2) reach the
    SP forward, non-square at 128 px, and the epoch writes its eval
    row."""
    import yolov5m_tpu_torch.parallel.sp as sp

    shapes = []
    real = sp.sp_forward

    def spy(model, mesh, images, *args, **kwargs):
        shapes.append(tuple(images.shape[1:3]))
        return real(model, mesh, images, *args, **kwargs)

    monkeypatch.setattr(sp, "sp_forward", spy)
    monkeypatch.chdir(tmp_path)
    _disk(tmp_path)
    cli.main(cli.arg_parser(DISK + ["--epochs", "1", "--rect", "--sp", "2",
                                    "--nosaveimgs", "--image_size", "128"]))
    out = capsys.readouterr().out
    assert "grid" in out and "MAP50" in out
    assert shapes and any(h != w for h, w in shapes), shapes
    logs = tmp_path / "train_eval_metrics" / "model_1"
    assert len(_lines(logs / "eval.csv")) == 2
    state = ck.load_checkpoint("SAVED_CHECKPOINT", "model_1", 1)
    assert all(torch.isfinite(v).all() for v in state["model"].values())


def test_disk_rect_keeps_host_augment_and_saves_images(tmp_path, monkeypatch,
                                                       capsys):
    monkeypatch.chdir(tmp_path)
    _disk(tmp_path)
    cli.main(cli.arg_parser(DISK + ["--epochs", "1", "--rect",
                                    "--device_augment", "--remat",
                                    "--nosavemodel"]))
    out = capsys.readouterr().out
    assert "keeping host-side augmentation" in out
    assert "autoanchor" not in out and "multi-scale" not in out
    saved = tmp_path / "SAVED_IMAGES" / "model_1" / "EPOCH_1"
    assert sorted(os.listdir(saved)) == ["image_0.png", "image_1.png"]
    assert not (tmp_path / "SAVED_CHECKPOINT" / "model_1" / "anchors.json"
                ).exists()


def _opt(**kw):
    base = dict(data="tiny", datasets_dir=None, bs=16, image_size=640,
                remat=False, no_remat=False)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("text", [YAML, BLOCK_YAML], ids=["flow", "block"])
def test_resolve_dataset_equals_jax(text, tmp_path, monkeypatch):
    root = _disk(tmp_path)
    with open(os.path.join(root, "data.yaml"), "w") as f:
        f.write(text)
    want = (root, 3, ["car", "person", "bike"])
    monkeypatch.chdir(tmp_path)
    assert cli.resolve_dataset(_opt()) == jcli.resolve_dataset(_opt()) == want
    opt = _opt(datasets_dir=str(tmp_path / "datasets"))
    assert cli.resolve_dataset(opt) == jcli.resolve_dataset(opt) == want
    nothing = _opt(data="none")
    assert cli.resolve_dataset(nothing) == jcli.resolve_dataset(nothing)
    _without(monkeypatch, "yaml")
    assert cli.resolve_dataset(_opt()) == want
    assert cli.resolve_dataset(_opt(data="synth"))[0] is None


def test_auto_remat_rule():
    assert not cli.wants_remat(_opt(bs=64))
    assert cli.wants_remat(_opt(bs=96))
    assert not cli.wants_remat(_opt(bs=96, no_remat=True))
    assert cli.wants_remat(_opt(bs=16, remat=True))
    assert not cli.wants_remat(_opt(bs=192, image_size=416))   # 81 at 640^2
    # the load is per device: the global --bs over the --dp ranks
    assert cli.wants_remat(_opt(bs=192), n_devices=2)
    assert not cli.wants_remat(_opt(bs=96), n_devices=2)


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
