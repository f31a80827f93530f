"""The port's utility modules (yolov5m_tpu_torch/utils/misc.py,
utils/torch_import.py) against the JAX package's, following
tests/test_export_prep.py: seed_everything reseeds the host generators,
StepTimer, profile_trace writes a Chrome trace, nan_debug switches
autograd's anomaly detection. torch_checkpoint_to_npz writes the JAX
function's npz from the same reference .pt, with and without --no-head,
and detect's --weights takes the .pt itself. Also chip_smoke.py's reader
of such a trace (device time by operation and the idle share)."""

import json
import os
import random

import numpy as np
import pytest
import torch

import chip_smoke
from yolov5m_tpu.utils import torch_import as jax_import
from yolov5m_tpu_torch.cli import detect
from yolov5m_tpu_torch.models.yolo import YOLOv5
from yolov5m_tpu_torch.utils import misc, torch_import

torch.set_num_threads(1)


def test_seed_everything_reseeds_every_generator():
    gen = misc.seed_everything(7)
    assert isinstance(gen, torch.Generator) and gen.initial_seed() == 7
    a = (random.random(), np.random.rand(), torch.rand(3), torch.rand(
        3, generator=gen))
    gen = misc.seed_everything(7)
    b = (random.random(), np.random.rand(), torch.rand(3), torch.rand(
        3, generator=gen))
    assert a[:2] == b[:2]
    assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])


def test_step_timer():
    t = misc.StepTimer(alpha=0.5)
    t.start()
    dt = t.stop()
    assert dt >= 0 and t.ema == dt
    t.start()
    dt2 = t.stop()
    assert t.ema == pytest.approx(0.5 * dt2 + 0.5 * dt)


def test_profile_trace_writes_a_chrome_trace(tmp_path, capsys):
    x = torch.rand(64, 64)
    with misc.profile_trace(str(tmp_path / "trace")) as prof:
        (x @ x).sum()
    path = tmp_path / "trace" / misc.TRACE_FILE
    assert path.is_file()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in a.key for a in prof.key_averages())
    with misc.profile_trace() as none:
        assert none is None
    assert "[profile] span took" in capsys.readouterr().out


def test_nan_debug_switches_anomaly_detection():
    try:
        misc.nan_debug(True)
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1.0).sum().backward()
    finally:
        misc.nan_debug(False)
    assert not torch.is_anomaly_enabled()


@pytest.fixture
def reference_pt(tmp_path):
    """A reference-style .pt: the state dict under "state_dict", with
    num_batches_tracked buffers and head.anchors."""
    torch.manual_seed(3)
    sd = dict(YOLOv5(first_out=8, nc=3, depth_mult=0.33).state_dict())
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(5)
    sd["head.anchors"] = torch.rand(3, 3, 2)
    path = tmp_path / "ref.pt"
    torch.save({"state_dict": sd}, path)
    return path, sd


@pytest.mark.parametrize("drop_head", (False, True))
def test_torch_checkpoint_to_npz_equals_jax(reference_pt, tmp_path,
                                            drop_head, capsys):
    pt, sd = reference_pt
    ours, theirs = tmp_path / "port.npz", tmp_path / "jax.npz"
    torch_import.main([str(pt), str(ours)] + (["--no-head"] if drop_head
                                              else []))
    n = jax_import.torch_checkpoint_to_npz(str(pt), str(theirs), drop_head)
    assert f"wrote {n} arrays" in capsys.readouterr().out
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) == n
        for k in a.files:
            assert a[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])
        assert not any(k.endswith("num_batches_tracked") or
                       k == "head.anchors" for k in a.files)
        assert any(k.startswith("head.") for k in a.files) != drop_head


def test_detect_weights_take_the_reference_pt(reference_pt):
    pt, sd = reference_pt
    opt = detect.arg_parser(["--weights", str(pt), "--nc", "3", "--model",
                             "n", "--first_out", "8", "--image_size", "64",
                             "--device", "cpu"])
    model, _ = detect.build_model(opt, 3, torch.device("cpu"))
    got = model.state_dict()
    assert set(got) == {k for k in sd if not k.endswith(
        "num_batches_tracked") and k != "head.anchors"}
    assert all(torch.equal(v, sd[k]) for k, v in got.items())


def test_chip_smoke_trace_summary(tmp_path):
    """Device busy time is the union of kernel, copy and set intervals;
    the window spans every event; operations sum by name."""
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 10, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 30, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 60,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "sort", "ts": 190, "dur": 10},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 500},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    top, idle, window = chip_smoke.trace_summary(str(path))
    assert window == pytest.approx(0.2)                  # ms
    assert idle == pytest.approx(1 - (40 + 10 + 10) / 200)
    assert top == [("gemm", pytest.approx(0.05)),
                   ("Memcpy HtoD", pytest.approx(0.01)),
                   ("sort", pytest.approx(0.01))]
    assert os.path.isfile(path)
