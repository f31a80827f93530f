"""The int8 models (quant "chain" and "block") under the port's SP and TP
(yolov5m_tpu_torch/parallel/sp.py, tp.py) and in its TP server, against
the JAX package on the virtual 8-device CPU mesh and against the port's
one-device int8 pipeline.

JAX's ``quantize_int8`` (chain and per block) quantizes a first_out 8
model, calibrated on two seeded batches; ``state_dict_from_flax_int8``
carries its tree across, so both packages run the same int8 weights and
scales. The grids: SP 1x2 and 1x4 at 128 px, SP 1x4 at 160 px (P5's 5
rows 2/2/1/0), TP 1x2 (w_q, s_w and bias rows split two ways, and the
head's 18 channels too) and TP 2x2. The model is the committed trained
fixture (tests/fixtures/tiny_trained_nc1.msgpack, first_out 8, nc 1) on
its red-rectangle scenes: a random init gives hundreds of detections of
near-equal confidence, whose order the ulps of the two SiLUs decide.
Bounds:

  * against JAX's ``make_sp_infer_fn`` / ``make_tp_infer_fn`` on the same
    int8 model: valid masks equal, detections within 1e-4 (the f32
    epilogues differ by the ulps of XLA's and torch's SiLU,
    tests/test_torch_quantize.py);
  * against the port's one-device int8 pipeline: the head's inputs equal
    bit for bit (the int32 accumulators are exact, and each piece's f32
    epilogue is the one-device arithmetic on its elements, a concat's
    operands added in order, each operand whole), the valid masks equal,
    and the detections within 1e-5, the float SP and TP tests' bound: the
    head's float 1x1 convs run on row shards or output-channel halves,
    for which the CPU's convolution may sum in another order (1 ulp on
    P5's logits at 160 px over 1x4);
  * ``variable_pspec`` equal to JAX's on every leaf of JAX's int8 tree at
    n_model 2, 3 and 4;
  * the TP server with the int8 chain model answers as the one-device
    server does, byte for byte;
  * PP still refuses an int8 model (JAX's ``StagePlan`` does too).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from flax import serialization

from tests.torch_parallel_common import KW, assert_same_detections
from yolov5m_tpu.models import YOLOv5 as JYOLOv5
from yolov5m_tpu.models.quantize import quantize_int8 as jax_quantize_int8
from yolov5m_tpu.models.yolo import normalized_anchors as jnormalized_anchors
from yolov5m_tpu.parallel import make_sp_infer_fn as jmake_sp_infer_fn
from yolov5m_tpu.parallel import make_tp_infer_fn as jmake_tp_infer_fn
from yolov5m_tpu.parallel import make_tp_mesh as jmake_tp_mesh
from yolov5m_tpu.parallel.tp import variable_pspec as jvariable_pspec
from yolov5m_tpu_torch.data.native import encode_ppm
from yolov5m_tpu_torch.models.weights import (_flatten,
                                              _module_token_to_torch,
                                              state_dict_from_flax_int8,
                                              torch_key_for_path)
from yolov5m_tpu_torch.models.yolo import YOLOv5, normalized_anchors
from yolov5m_tpu_torch.ops.postprocess import fused_detect
from yolov5m_tpu_torch.parallel import (make_pp_infer_fn, make_pp_mesh,
                                        make_sp_infer_fn, make_tp_infer_fn,
                                        make_tp_mesh)
from yolov5m_tpu_torch.parallel.mesh import Mesh
from yolov5m_tpu_torch.parallel.sp import SpatialOps
from yolov5m_tpu_torch.parallel.tp import ChannelOps, variable_pspec
from yolov5m_tpu_torch.serving.server import DetectionClient, DetectionServer

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "tiny_trained_nc1.msgpack")
NC = 1
SCHEMES = ("chain", "block")
# (kind, H, n_data, n_axis, bs)
GRIDS = [("sp", 128, 1, 2, 2), ("sp", 128, 1, 4, 2), ("sp", 160, 1, 4, 2),
         ("tp", 128, 1, 2, 2), ("tp", 128, 2, 2, 4)]


def _scenes(bs, h, w, seed) -> np.ndarray:
    """tests/test_quantize_learned.py's scenes at h x w: a red rectangle
    on noise, the object the trained fixture learned."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 0.25, (bs, h, w, 3)).astype(np.float32)
    for b in range(bs):
        bw, bh = rng.uniform(0.3, 0.5, 2)
        cx, cy = rng.uniform(bw / 2, 1 - bw / 2), rng.uniform(bh / 2,
                                                              1 - bh / 2)
        img[b, int((cy - bh / 2) * h):int((cy + bh / 2) * h),
            int((cx - bw / 2) * w):int((cx + bw / 2) * w)] = (0.9, 0.2, 0.2)
    return img


@pytest.fixture(scope="module")
def int8_pairs():
    """scheme -> (JAX int8 model, its variables, the port's int8 model on
    JAX's tree): the trained fixture, calibrated on two seeded batches."""
    jmodel = JYOLOv5(first_out=8, nc=NC, dtype=jnp.float32)
    template = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 128, 128, 3)))
    with open(FIXTURE, "rb") as f:
        variables = serialization.from_bytes(
            {"params": template["params"],
             "batch_stats": template["batch_stats"]}, f.read())
    calib = [jnp.asarray(_scenes(8, 128, 128, seed)) for seed in (1, 2)]
    out = {}
    for scheme in SCHEMES:
        qmodel, qvars = jax_quantize_int8(jmodel, variables, calib,
                                          chain=scheme == "chain")
        qvars = jax.tree.map(np.asarray, qvars)
        port = YOLOv5(first_out=8, nc=NC, fused=True, quant=scheme).eval()
        port.load_state_dict({k: torch.from_numpy(v) for k, v in
                              state_dict_from_flax_int8(qvars).items()},
                             strict=True)
        out[scheme] = (qmodel, qvars, port)
    return out


def _jax_infer(kind, qmodel, qvars, n_data, n_axis):
    if kind == "sp":
        jmesh = JMesh(np.asarray(jax.devices()[:n_axis]), ("spatial",))
        return jmake_sp_infer_fn(qmodel, qvars, jnormalized_anchors(), jmesh,
                                 **KW)
    data_axis = "data" if n_data > 1 else None
    return jmake_tp_infer_fn(qmodel, qvars, jnormalized_anchors(),
                             jmake_tp_mesh(n_data=n_data, n_model=n_axis),
                             data_axis=data_axis, **KW)


def _port_infer(kind, port, n_data, n_axis):
    if kind == "sp":
        return make_sp_infer_fn(port, normalized_anchors(),
                                Mesh(["cpu"] * n_axis, ("spatial",)), **KW)
    return make_tp_infer_fn(port, normalized_anchors(),
                            make_tp_mesh(n_data, n_axis, device="cpu"),
                            data_axis="data" if n_data > 1 else None, **KW)


def _joined(kind, pieces) -> torch.Tensor:
    """A grid's NCHW value as one tensor: SP row shards (None where
    empty) joined along H, TP channel chunks along C, then the batch."""
    if kind == "sp":
        return torch.cat([torch.cat([t for t in row if t is not None], 2)
                          for row in pieces])
    return torch.cat([torch.cat(chunks, 1) for chunks in pieces])


@pytest.mark.parametrize("kind,h,n_data,n_axis,bs", GRIDS,
                         ids=lambda v: str(v))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_int8_grid_matches_jax_and_one_device(int8_pairs, monkeypatch, scheme,
                                              kind, h, n_data, n_axis, bs):
    qmodel, qvars, port = int8_pairs[scheme]
    x = _scenes(bs, h, 128, seed=h + n_axis + n_data)
    want = jax.device_get(_jax_infer(kind, qmodel, qvars, n_data, n_axis)(x))

    seen = []
    ops = SpatialOps if kind == "sp" else ChannelOps
    real = ops.head_pieces

    def record(self, head, feats):
        seen.append([_joined(kind, f) for f in feats])
        return real(self, head, feats)

    monkeypatch.setattr(ops, "head_pieces", record)
    got = _port_infer(kind, port, n_data, n_axis)(torch.from_numpy(x))
    assert_same_detections(got, want, 1e-4)

    inputs = []
    hook = port.head.register_forward_pre_hook(
        lambda module, args: inputs.append(list(args[0])))
    try:
        with torch.no_grad():
            one = fused_detect(port(torch.from_numpy(x)),
                               torch.from_numpy(normalized_anchors()), **KW)
    finally:
        hook.remove()
    # the int8 graph is the one-device one, bit for bit
    for g, w in zip(seen[0], inputs[0]):
        assert torch.equal(g, w)
    assert torch.equal(got[1], one[1])
    torch.testing.assert_close(got[0], one[0], rtol=1e-5, atol=1e-5)


def _transposed(jspec, ndim):
    """A JAX spec on an HWIO kernel as the spec on its OIHW twin."""
    spec = tuple(jspec)
    if ndim == 4 and spec:
        spec = spec + (None,) * (4 - len(spec))
        return (spec[3], spec[2], spec[0], spec[1])
    return spec


@pytest.mark.parametrize("n_model", [2, 3, 4])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_variable_pspec_equals_jax_on_the_int8_tree(int8_pairs, scheme,
                                                    n_model):
    _, qvars, port = int8_pairs[scheme]
    sd = port.state_dict()
    seen = 0
    for path, leaf in _flatten(qvars["params"]):
        key = (torch_key_for_path("params", path) if path[0] == "head"
               else ".".join([_module_token_to_torch(t) for t in path[:-1]]
                             + [path[-1]]))
        want = _transposed(jvariable_pspec(leaf, n_model, "model"),
                           np.ndim(leaf))
        assert variable_pspec(sd[key], n_model) == want, key
        seen += 1
    assert seen == len(sd)


def test_tp_server_serves_the_int8_model_as_one_device(int8_pairs):
    """DetectionServer(tp_devices=["cpu", "cpu"]) with the int8 chain
    model: every reply equal to the one-device server's."""
    port = int8_pairs["chain"][2]
    frames = [encode_ppm((255 * _scenes(1, 96 + 16 * i, 128, 20 + i)[0])
                         .astype(np.uint8)) for i in range(4)]
    replies = {}
    for name, extra in (("tp", dict(tp_devices=["cpu", "cpu"])), ("one", {})):
        server = DetectionServer(port, normalized_anchors(), image_size=128,
                                 batch_size=2, max_wait_ms=200.0, **KW,
                                 **extra)
        assert (server._tp_infer is not None) == (name == "tp")
        with server, DetectionClient(port=server.port) as client:
            for f in frames:
                client.send(f)
            replies[name] = [client.recv() for _ in frames]
    assert all(r["ok"] for r in replies["tp"])
    assert replies["tp"] == replies["one"]
    assert sum(len(r["detections"]) for r in replies["tp"]) > 0


def test_pp_still_refuses_the_int8_model(int8_pairs):
    port = int8_pairs["block"][2]
    with pytest.raises(ValueError, match="pipelines the float graph"):
        make_pp_infer_fn(port, normalized_anchors(),
                         make_pp_mesh(2, device="cpu"), 1, 2,
                         image_hw=(128, 128), **KW)
