"""The port's data-parallel inference (yolov5m_tpu_torch/parallel/infer.py)
and DetectionServer(dp_devices=...) on the CPU, over the device list
["cpu", "cpu"]:

  * against JAX ``make_dp_infer_fn`` on ``make_mesh(2)`` with the same
    BN-folded weights, the pattern and tolerance of tests/test_dp_infer.py
    (valid equal, det within 1e-5; the frames are normalized by numpy for
    JAX, as ``normalize_uint8`` does);
  * against the port's one-device pipeline on each shard: exactly equal;
  * a batch that is not a multiple of the device count raises;
  * the DP server answers a pipelined client exactly as a one-device
    server whose batch is one replica's shard;
  * ``cli/serve.py --dp 2 --device cpu`` serves, and the --dp refusal;
    ``--tp 2`` serves as the one-device server does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov5m_tpu.models import YOLOv5 as JYOLOv5
from yolov5m_tpu.models.fuse import fold_batchnorm as jfold
from yolov5m_tpu.parallel import make_dp_infer_fn as jmake_dp_infer_fn
from yolov5m_tpu.parallel import make_mesh, shard_batch
from yolov5m_tpu_torch.data.native import encode_ppm
from yolov5m_tpu_torch.models.weights import state_dict_from_flax
from yolov5m_tpu_torch.models.yolo import YOLOv5, normalized_anchors
from yolov5m_tpu_torch.ops.postprocess import fused_detect
from yolov5m_tpu_torch.ops.preprocess import normalize_uint8
from yolov5m_tpu_torch.parallel import make_dp_infer_fn
from yolov5m_tpu_torch.serving.server import DetectionClient, DetectionServer

torch.set_num_threads(1)

NC, HW = 4, 64
KW = dict(conf_threshold=0.01, iou_threshold=0.45, max_detections=32,
          pre_nms_topk=64)
DEVICES = ["cpu", "cpu"]


@pytest.fixture(scope="module")
def fused():
    jmodel = JYOLOv5(first_out=8, nc=NC, depth_mult=0.33)
    variables = jfold(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3), jnp.float32)))
    model = YOLOv5(first_out=8, nc=NC, depth_mult=0.33, fused=True).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           state_dict_from_flax(variables).items()})
    return jmodel.clone(fused=True), variables, model


def _frames(bs, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (bs, HW, HW, 3),
                                                np.uint8)


def test_dp_infer_matches_jax(fused):
    jmodel, variables, model = fused
    frames = _frames(4)
    mesh = make_mesh(2)
    jinfer = jmake_dp_infer_fn(jmodel, variables, normalized_anchors(), mesh,
                               **KW)
    images = frames.astype(np.float32) / np.float32(255)
    want_det, want_valid = jax.device_get(
        jinfer(shard_batch({"image": images}, mesh)["image"]))
    det, valid = make_dp_infer_fn(model, normalized_anchors(), DEVICES,
                                  **KW)(torch.from_numpy(frames))
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    np.testing.assert_allclose(det.numpy()[want_valid], want_det[want_valid],
                               rtol=1e-5, atol=1e-5)
    assert want_valid.any(), "degenerate test: no detections survived"


def test_dp_infer_equals_one_device_pipeline_per_shard(fused):
    model = fused[2]
    frames = torch.from_numpy(_frames(6, seed=1))
    det, valid = make_dp_infer_fn(model, normalized_anchors(),
                                  ["cpu"] * 3, **KW)(frames)
    anchors = torch.from_numpy(normalized_anchors())
    for i in range(3):
        with torch.inference_mode():
            want = fused_detect(model(normalize_uint8(
                frames[2 * i:2 * i + 2], torch.float32)), anchors, **KW)
        assert torch.equal(det[2 * i:2 * i + 2], want[0])
        assert torch.equal(valid[2 * i:2 * i + 2], want[1])
    assert valid.any()


def test_batch_must_be_a_multiple_of_the_devices(fused):
    model = fused[2]
    infer = make_dp_infer_fn(model, normalized_anchors(), DEVICES, **KW)
    with pytest.raises(ValueError, match="not a multiple"):
        infer(torch.from_numpy(_frames(3)))
    with pytest.raises(ValueError, match="multiple"):
        DetectionServer(model, normalized_anchors(), image_size=HW,
                        batch_size=3, dp_devices=DEVICES, **KW)
    with pytest.raises(ValueError, match="one kind"):
        make_dp_infer_fn(model, normalized_anchors(), [], **KW)


def _replies(server, frames):
    with server, DetectionClient(port=server.port) as c:
        for f in frames:                     # pipelined: full batches
            c.send(f)
        return [c.recv() for _ in frames]


def test_dp_server_answers_as_the_one_device_server(fused):
    """4 frames from one pipelined client: the DP server's batch of 4 is
    two shards of 2, the one-device server's two batches of 2, so each
    frame sits at the same row of the same shape on both."""
    model = fused[2]
    frames = [encode_ppm(f) for f in _frames(4, seed=2)]
    kw = dict(image_size=HW, max_wait_ms=2000.0, **KW)
    dp = _replies(DetectionServer(model, normalized_anchors(), batch_size=4,
                                  dp_devices=DEVICES, **kw), frames)
    one = _replies(DetectionServer(model, normalized_anchors(), batch_size=2,
                                   **kw), frames)
    assert dp == one
    assert all(r["ok"] for r in dp) and sum(len(r["detections"])
                                            for r in dp) > 0


def test_serve_cli_dp_on_the_cpu(tmp_path):
    from yolov5m_tpu_torch.cli import serve

    model = YOLOv5(first_out=8, nc=3, depth_mult=0.33)
    path = tmp_path / "w.npz"
    np.savez(path, **{k: v.numpy() for k, v in model.state_dict().items()})
    base = ["--weights", str(path), "--nc", "3", "--model", "n",
            "--first_out", "8", "--image_size", "64", "--port", "0",
            "--device", "cpu"]
    server = serve.build_server(serve.arg_parser(base + ["--dp", "2",
                                                         "--bs", "4"]))
    assert server._dp_infer is not None and server.batch_size == 4
    with server, DetectionClient(port=server.port) as c:
        resp = c.detect(encode_ppm(_frames(1, seed=3)[0][:48]))
    assert resp["ok"] is True and (resp["height"], resp["width"]) == (48, 64)
    one = serve.build_server(serve.arg_parser(base + ["--dp", "0"]))
    assert one._dp_infer is None
    with pytest.raises(SystemExit, match="multiple of --dp"):
        serve.build_server(serve.arg_parser(base + ["--dp", "3", "--bs",
                                                    "4"]))
    # --tp 2: the channels split over two "cpu" cells, answering as the
    # one-device server does
    tp = serve.build_server(serve.arg_parser(base + ["--tp", "2"]))
    assert tp._tp_infer is not None and tp._dp_infer is None
    frame = encode_ppm(_frames(1, seed=4)[0])
    answers = []
    for srv in (tp, one):
        with srv, DetectionClient(port=srv.port) as c:
            answers.append(c.detect(frame))
    assert answers[0] == answers[1] and answers[0]["ok"] is True
