"""The port's export (yolov5m_tpu_torch/utils/onnx_export.py, onnx_proto.py,
export.py, utils/checkpoint.py:strip_checkpoint, cli/export.py) against the
JAX package's on the same weights: a first_out 8, nc 4 model at 128 px
(as tests/test_onnx_export.py), its flax variables with BatchNorm
statistics drawn from a seed, carried to the port by state_dict_from_flax.

The ONNX file must be byte-equal to JAX export_onnx's, parse back to the
YOLOv5 topology, pass protoc, and run (through the independent torch
interpreter of tests/test_onnx_export.py) to the port's forward within
1e-4. The torch.export program, saved and loaded, must equal the eager
port exactly on the CPU and JAX load_stablehlo's artifact within 1e-4 of
each output's largest magnitude, with and without postprocess (valid
masks exactly)."""

import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_onnx_export import _torch_run
from yolov5m_tpu.models import YOLOv5 as JaxYOLOv5
from yolov5m_tpu.utils import export as jax_export
from yolov5m_tpu.utils.onnx_export import export_onnx as jax_export_onnx
from yolov5m_tpu_torch.cli import detect
from yolov5m_tpu_torch.cli import export as export_cli
from yolov5m_tpu_torch.models.weights import state_dict_from_flax
from yolov5m_tpu_torch.models.yolo import YOLOv5
from yolov5m_tpu_torch.utils import export
from yolov5m_tpu_torch.utils.checkpoint import strip_checkpoint
from yolov5m_tpu_torch.utils.onnx_export import export_onnx
from yolov5m_tpu_torch.utils.onnx_proto import decode_model, summarize_model

torch.set_num_threads(1)

FO, NC, HW = 8, 4, 128
CONF = 0.55            # about a sixth of the rows clear it


@pytest.fixture(scope="module")
def weights():
    """(JAX model, flax variables as numpy, the port's f32 model)."""
    jmodel = JaxYOLOv5(first_out=FO, nc=NC, dtype=jnp.float32)
    variables = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3))))
    rng = np.random.default_rng(0)
    stats = jax.tree.map(lambda v: v.copy(), variables["batch_stats"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(stats)[0]:
        if path[-1].key == "mean":
            leaf[...] = rng.normal(0, 0.2, leaf.shape)
        else:
            leaf[...] = rng.uniform(0.5, 2.0, leaf.shape)
    params = jax.tree.map(lambda v: v.copy(), variables["params"])
    for head_conv in params["head"].values():
        # spread the objectness logits (about 1e-3 at init), so that the
        # confidence gate splits the rows far from any f32 difference
        head_conv["kernel"] *= 300.0
    variables = {"params": params, "batch_stats": stats}
    model = YOLOv5(first_out=FO, nc=NC).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           state_dict_from_flax(variables).items()})
    return jmodel, variables, model


@pytest.fixture(scope="module")
def onnx_files(weights, tmp_path_factory):
    _, variables, model = weights
    folder = tmp_path_factory.mktemp("onnx")
    ours = export_onnx(model.state_dict(), str(folder / "port.onnx"),
                       nc=NC, first_out=FO, image_size=HW)
    theirs = jax_export_onnx(variables, str(folder / "jax.onnx"), nc=NC,
                             first_out=FO, image_size=HW)
    return ours, theirs


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _x(seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (1, HW, HW, 3)).astype(np.float32)


def test_onnx_bytes_equal_jax(onnx_files):
    ours, theirs = onnx_files
    assert _read(ours) == _read(theirs)


def test_onnx_structure(onnx_files):
    s = summarize_model(_read(onnx_files[0]))
    assert s["ir_version"] == 6 and s["opset"] == 11
    assert s["inputs"] == ["images"] and s["outputs"] == ["p3", "p4", "p5"]
    ops = [o for o, _ in s["ops"]]
    counts = {op: ops.count(op) for op in set(ops)}
    assert counts == {"Conv": 82, "Sigmoid": 79, "Mul": 79, "MaxPool": 3,
                      "Resize": 2, "Add": 14, "Concat": 13, "Reshape": 3,
                      "Transpose": 3}
    assert s["n_inits"] >= 2 * 82


def test_onnx_protoc_accepts_the_bytes(onnx_files, tmp_path):
    if shutil.which("protoc") is None:
        pytest.skip("protoc not available")
    # the subset of the public onnx.proto that tests/test_onnx_export.py uses
    proto = tmp_path / "onnx_subset.proto"
    proto.write_text("""
syntax = "proto3";
package onnx;
message AttributeProto {
  string name = 1; float f = 2; int64 i = 3; bytes s = 4;
  TensorProto t = 5; repeated float floats = 7; repeated int64 ints = 8;
  int32 type = 20;
}
message TensorProto {
  repeated int64 dims = 1; int32 data_type = 2;
  repeated float float_data = 4; string name = 8; bytes raw_data = 9;
}
message NodeProto {
  repeated string input = 1; repeated string output = 2; string name = 3;
  string op_type = 4; repeated AttributeProto attribute = 5;
}
message TensorShapeProto {
  message Dimension { oneof value { int64 dim_value = 1; string dim_param = 2; } }
  repeated Dimension dim = 1;
}
message TypeProto {
  message Tensor { int32 elem_type = 1; TensorShapeProto shape = 2; }
  Tensor tensor_type = 1;
}
message ValueInfoProto { string name = 1; TypeProto type = 2; }
message GraphProto {
  repeated NodeProto node = 1; string name = 2;
  repeated TensorProto initializer = 5;
  repeated ValueInfoProto input = 11; repeated ValueInfoProto output = 12;
}
message OperatorSetIdProto { string domain = 1; int64 version = 2; }
message ModelProto {
  int64 ir_version = 1; string producer_name = 2; GraphProto graph = 7;
  repeated OperatorSetIdProto opset_import = 8;
}
""")
    r = subprocess.run(
        ["protoc", f"--proto_path={tmp_path}", "--decode=onnx.ModelProto",
         "onnx_subset.proto"], input=_read(onnx_files[0]),
        capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr.decode()[:500]
    text = r.stdout.decode()
    assert 'op_type: "Conv"' in text and 'name: "p5"' in text
    assert "ir_version: 6" in text


def test_onnx_graph_runs_to_the_port_forward(weights, onnx_files):
    _, _, model = weights
    x = _x(1)
    got = _torch_run(decode_model(_read(onnx_files[0])),
                     x.transpose(0, 3, 1, 2))
    with torch.no_grad():
        want = model(torch.from_numpy(x))
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-4, atol=1e-4)


def _within(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("with_postprocess", (False, True))
def test_program_equals_eager_and_jax(weights, tmp_path, with_postprocess):
    jmodel, variables, model = weights
    path = export.export_program(model, str(tmp_path / "m.pt2"),
                                 input_shape=(1, HW, HW, 3),
                                 with_postprocess=with_postprocess,
                                 conf=CONF)
    program = export.load_program(path)
    x = torch.from_numpy(_x(2))
    with torch.no_grad():
        got = program(x)
        eager = (export._WithPostprocess(
            model, program.anchors.numpy(), CONF, 0.45)(x)
            if with_postprocess else tuple(model(x)))
    assert len(got) == len(eager)
    for g, e in zip(got, eager):
        assert torch.equal(g, e)
    jpath = jax_export.export_stablehlo(
        jmodel, variables, str(tmp_path / "m.stablehlo"),
        input_shape=(1, HW, HW, 3), with_postprocess=with_postprocess,
        conf=CONF)
    want = jax_export.load_stablehlo(jpath)(jnp.asarray(x.numpy()))
    if with_postprocess:
        (out, valid), (j_out, j_valid) = got, want
        np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
        assert 0 < int(valid.sum()) < 300
        np.testing.assert_array_equal(out[..., 0].numpy(),
                                      np.asarray(j_out)[..., 0])
        for col in range(1, 6):
            _within(out[..., col], np.asarray(j_out)[..., col])
    else:
        for g, w in zip(got, want):
            _within(g, w)


def test_counters_equal_jax(weights):
    _, variables, model = weights
    assert export.count_parameters(model) == \
        jax_export.count_parameters(variables)
    assert export.model_size_mb(model) == jax_export.model_size_mb(variables)


def test_chip_smoke_flagship_parameter_count_is_jax():
    """chip_smoke.py holds the full-width model's count against this."""
    variables = jax.eval_shape(lambda: JaxYOLOv5(first_out=48, nc=80).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    assert chip_smoke.JAX_FLAGSHIP_PARAMETERS == \
        jax_export.count_parameters(variables) == \
        export.count_parameters(YOLOv5(first_out=48, nc=80))


def _trainer_state(model):
    return {"step": 3, "model": model.state_dict(),
            "optimizer": {"state": {}},
            "ema": [p.detach() * 0.5 for p in model.parameters()],
            "accum": [None for _ in model.parameters()]}


def test_strip_checkpoint_keeps_the_ema_in_bf16(weights, tmp_path):
    _, _, model = weights
    state = _trainer_state(model)
    stripped = strip_checkpoint(state, model)
    sd = model.state_dict()
    assert set(stripped) == set(sd)
    assert all(v.dtype == torch.bfloat16 for v in stripped.values())
    names = [n for n, _ in model.named_parameters()]
    for name, ema in zip(names, state["ema"]):
        assert torch.equal(stripped[name], ema.to(torch.bfloat16))
    for name in set(sd) - set(names):
        assert torch.equal(stripped[name], sd[name].to(torch.bfloat16))
    plain = strip_checkpoint(state, model, keep_ema=False)
    assert all(torch.equal(plain[k], v.to(torch.bfloat16))
               for k, v in sd.items())

    # detect's --checkpoint loads the stripped state dict
    path = tmp_path / "stripped.pt"
    torch.save(stripped, path)
    opt = detect.arg_parser(["--checkpoint", str(path), "--nc", str(NC),
                             "--first_out", str(FO), "--image_size",
                             str(HW), "--device", "cpu"])
    loaded, _ = detect.build_model(opt, NC, torch.device("cpu"))
    got = loaded.state_dict()
    assert all(torch.equal(got[k], v.float()) for k, v in stripped.items())


def test_cli_writes_both_files(weights, onnx_files, tmp_path):
    _, _, model = weights
    npz = tmp_path / "w.npz"
    np.savez(npz, **{k: v.numpy() for k, v in model.state_dict().items()})
    onnx, program = tmp_path / "m.onnx", tmp_path / "m.pt2"
    export_cli.main(export_cli.arg_parser(
        ["--weights", str(npz), "--nc", str(NC), "--first_out", str(FO),
         "--image_size", str(HW), "--onnx", str(onnx), "--program",
         str(program), "--device", "cpu"]))
    assert _read(onnx) == _read(onnx_files[0])
    x = torch.from_numpy(_x(3))
    with torch.no_grad():
        got = export.load_program(str(program))(x)
        want = model(x)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(SystemExit, match="--onnx and/or --program"):
        export_cli.main(export_cli.arg_parser(["--device", "cpu"]))
    assert os.path.isfile(program)
