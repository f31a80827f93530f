"""The port's detection server (yolov5m_tpu_torch/serving/server.py) against
the JAX package's, both on the CPU with the same weights, over real sockets.

Frames are 640x640, so the host letterbox needs no resize and is
byte-equal on both sides; they are lossless (PPM, PNG) or JPEG, which the
JAX server decodes with libjpeg and the port's with its own decoder, to the
same pixels; and the 640x480 scenes of tests/torch_pillow_corpus.py and
tests/torch_webp_corpus.py that the JAX server hands to Pillow (CMYK,
YCCK, GIF, BMP, WebP) and PNM frames Pillow's PPM plugin reads (plain,
16-bit, other maxvals), which the port decodes without PIL. Replies must
agree in classes and counts; confidences within 1e-4
and boxes within 0.05 px (f32 convolutions summed in another order, and
the JSON rounds to 5 and 2 decimals)."""

import io
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from yolov5m_tpu.models import YOLOv5 as JaxYOLOv5
from yolov5m_tpu.models.fuse import fold_batchnorm as jax_fold
from yolov5m_tpu.models.yolo import normalized_anchors
from yolov5m_tpu.serving import DetectionClient as JaxClient
from yolov5m_tpu.serving import DetectionServer as JaxServer
from yolov5m_tpu_torch.data.native import encode_ppm, letterbox
from yolov5m_tpu_torch.models.weights import state_dict_from_flax
from yolov5m_tpu_torch.models.yolo import YOLOv5
from yolov5m_tpu_torch.ops.boxes import unletterbox_boxes_np
from yolov5m_tpu_torch.ops.postprocess import fused_detect
from yolov5m_tpu_torch.serving.server import DetectionClient, DetectionServer

torch.set_num_threads(1)

NC, S = 4, 640
LABELS = ["a", "b", "c", "d"]
KW = dict(conf_threshold=0.01, iou_threshold=0.45, max_detections=16,
          pre_nms_topk=32)


def _model():
    jmodel = JaxYOLOv5(first_out=8, nc=NC, depth_mult=0.33)
    variables = jax_fold(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    model = YOLOv5(first_out=8, nc=NC, depth_mult=0.33, fused=True).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           state_dict_from_flax(variables).items()})
    return jmodel.clone(fused=True), variables, model


@pytest.fixture(scope="module")
def servers():
    jmodel, variables, model = _model()
    port_srv = DetectionServer(model, normalized_anchors(), labels=LABELS,
                               image_size=S, batch_size=2, max_wait_ms=10.0,
                               **KW)
    jax_srv = JaxServer(jmodel, variables, normalized_anchors(),
                        labels=LABELS, image_size=S, batch_size=2,
                        max_wait_ms=10.0, **KW)
    with port_srv, jax_srv:
        yield port_srv, jax_srv, model


def _frame(seed, hw=(S, S)):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3), np.uint8)


def _png(img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return buf.getvalue()


def _agree(got, want):
    assert got["ok"] is True and want["ok"] is True
    assert (got["height"], got["width"]) == (want["height"], want["width"])
    assert [d["class_id"] for d in got["detections"]] == \
        [d["class_id"] for d in want["detections"]]
    assert [d["label"] for d in got["detections"]] == \
        [d["label"] for d in want["detections"]]
    for g, w in zip(got["detections"], want["detections"]):
        np.testing.assert_allclose(g["confidence"], w["confidence"],
                                   atol=1e-4)
        np.testing.assert_allclose(g["box"], w["box"], atol=0.05)


def _jpg(img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=90)
    return buf.getvalue()


@pytest.mark.parametrize("fmt", ("ppm", "png", "jpg"))
def test_replies_match_jax_server(servers, fmt):
    port_srv, jax_srv, _ = servers
    data = {"ppm": encode_ppm, "png": _png, "jpg": _jpg}[fmt](_frame(1))
    with DetectionClient(port=port_srv.port) as c:
        got = c.detect(data)
    with JaxClient(port=jax_srv.port) as c:
        want = c.detect(data)
    assert got["detections"], "degenerate test: no detections at conf 0.01"
    _agree(got, want)


def _direct(model, img):
    """The port's own pipeline on one frame: host letterbox, /255, model,
    fused_detect, unletterbox."""
    boxed, ratio, dwdh = letterbox(img, (S, S))
    x = torch.from_numpy(boxed[None].astype(np.float32) / 255.0)
    with torch.no_grad():
        det, valid = fused_detect(model(x), normalized_anchors(), **KW)
    rows = det[0][valid[0]].numpy()
    return rows, unletterbox_boxes_np(rows[:, 2:6], ratio, dwdh,
                                      img.shape[:2])


@pytest.mark.parametrize("hw", ((480, 640), (640, 400)))
def test_non_square_matches_direct_pipeline(servers, hw):
    port_srv, _, model = servers
    img = _frame(2, hw)
    with DetectionClient(port=port_srv.port) as c:
        resp = c.detect(encode_ppm(img))
    rows, boxes = _direct(model, img)
    assert resp["ok"] is True and (resp["height"], resp["width"]) == hw
    assert len(resp["detections"]) == len(rows) > 0
    for d, r, b in zip(resp["detections"], rows, boxes):
        assert d["class_id"] == int(r[0])
        np.testing.assert_allclose(d["confidence"], r[1], atol=1e-4)
        np.testing.assert_allclose(d["box"], b, atol=0.02)


def test_pipelined_replies_in_order(servers):
    """Two clients each send three frames before reading: more requests
    than a batch, and every reply is its own frame's (distinct heights)."""
    port_srv, _, _ = servers
    frames = {i: encode_ppm(_frame(10 + i, (600 + 8 * i, S)))
              for i in range(6)}
    replies = [None, None]

    def client(c):
        mine = list(range(c, 6, 2))
        with DetectionClient(port=port_srv.port) as cl:
            for i in mine:
                cl.send(frames[i])
            replies[c] = [(i, cl.recv()) for i in mine]

    threads = [threading.Thread(target=client, args=(c,)) for c in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for pairs in replies:
        assert pairs is not None
        for i, resp in pairs:
            assert resp["ok"] is True and resp["height"] == 600 + 8 * i


@pytest.mark.parametrize("name", ["scene_cmyk_640x480.jpg",
                                  "scene_ycck_640x480.jpg",
                                  "scene_640x480.gif", "scene_640x480.bmp"])
def test_pillow_route_frames_match_jax_server(servers, name, monkeypatch):
    """Frames the JAX server's libjpeg refuses and hands to Pillow (CMYK,
    YCCK, GIF, BMP): the port's server, without PIL, answers them with the
    detections JAX answers from its _decode_image's pixels."""
    import os
    import sys

    from tests import torch_pillow_corpus

    port_srv, jax_srv, _ = servers
    with open(os.path.join(torch_pillow_corpus.FOLDER, name), "rb") as f:
        data = f.read()
    with JaxClient(port=jax_srv.port) as c:
        want = c.detect(data)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with DetectionClient(port=port_srv.port) as c:
        got = c.detect(data)
    assert got["detections"], "degenerate test: no detections at conf 0.01"
    _agree(got, want)


@pytest.mark.parametrize("name", ["scene_lossy_640x480.webp",
                                  "scene_lossless_640x480.webp",
                                  "scene_alpha_640x480.webp"])
def test_webp_frames_match_ppm_twins_and_jax(servers, name, monkeypatch):
    """WebP frames (lossy, lossless, with alpha), which the JAX server
    hands to Pillow: the port's server, without PIL, answers each exactly
    as it answers a PPM of Pillow's pixels, and as JAX answers; a cut
    WebP is refused by both."""
    import os
    import sys

    from tests import torch_webp_corpus

    port_srv, jax_srv, _ = servers
    with open(os.path.join(torch_webp_corpus.FOLDER, name), "rb") as f:
        data = f.read()
    twin = encode_ppm(torch_webp_corpus.pillow_decode(data))
    with JaxClient(port=jax_srv.port) as c:
        want = c.detect(data)
        cut_want = c.detect(data[:-1])
    monkeypatch.setitem(sys.modules, "PIL", None)
    with DetectionClient(port=port_srv.port) as c:
        got = c.detect(data)
        got_twin = c.detect(twin)
        cut_got = c.detect(data[:-1])
    assert got["detections"], "degenerate test: no detections at conf 0.01"
    assert got == got_twin
    _agree(got, want)
    assert cut_want["ok"] is False and cut_got["ok"] is False
    assert "undecodable" in cut_got["error"]


@pytest.mark.parametrize("kind", ["p3", "p5_16bit", "p6_maxval100"])
def test_pnm_frames_match_ppm_twins_and_jax(servers, kind, monkeypatch):
    """PNM frames the JAX server hands to Pillow (plain P3, a 16-bit P5, a
    P6 at maxval 100) of the 640x480 scene: the port's server, without
    PIL, answers each exactly as it answers a P6 of Pillow's pixels, and
    as JAX answers; a header Pillow's PPM plugin passes on (the magic
    number runs to the first whitespace) is refused by both."""
    import sys

    from tests import torch_jpeg_fixtures, torch_pillow_corpus
    from tests import torch_pnm_corpus as corpus

    port_srv, jax_srv, _ = servers
    rgb = torch_jpeg_fixtures.scene(0).astype(np.int64)
    h, w = rgb.shape[:2]
    data = {
        "p3": corpus.header(b"P3", w, h, 255) + corpus.plain(rgb),
        "p5_16bit": corpus.header(b"P5", w, h, 65535) + corpus.binary(
            rgb.sum(-1) // 3, 65535),
        "p6_maxval100": corpus.header(b"P6", w, h, 100) + corpus.binary(
            np.round(rgb * (100 / 255)).astype(np.int64), 100),
    }[kind]
    bad = b"P6#x\n%d %d\n255\n" % (w, h) + rgb.astype(np.uint8).tobytes()
    twin = encode_ppm(torch_pillow_corpus.pillow_decode(data))
    with JaxClient(port=jax_srv.port) as c:
        want = c.detect(data)
        bad_want = c.detect(bad)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with DetectionClient(port=port_srv.port) as c:
        got = c.detect(data)
        got_twin = c.detect(twin)
        bad_got = c.detect(bad)
    assert got["detections"], "degenerate test: no detections at conf 0.01"
    assert got == got_twin
    _agree(got, want)
    assert bad_want["ok"] is False and bad_got["ok"] is False
    assert "undecodable" in bad_got["error"]


@pytest.mark.parametrize("kind", ["lzw_pred2", "deflate_tiles", "packbits",
                                  "planar_orient3"])
def test_tiff_frames_match_ppm_twins_and_jax(servers, kind, monkeypatch):
    """TIFF frames the JAX server hands to Pillow (LZW with predictor 2,
    deflate in tiles, PackBits, uncompressed planes under Orientation 3)
    of the 640x480 scene: the port's server, without PIL, answers each
    exactly as it answers a PPM of Pillow's pixels, and as JAX answers; a
    TIFF whose compression Pillow does not know, and one cut short, are
    refused by both."""
    import sys

    from tests import torch_jpeg_fixtures, torch_pillow_corpus
    from tests import torch_tiff_corpus as corpus

    port_srv, jax_srv, _ = servers
    rgb = torch_jpeg_fixtures.scene(0)
    data = {
        "lzw_pred2": lambda: corpus.encode(rgb, "lzw", predictor=2),
        "deflate_tiles": lambda: corpus.encode(rgb, "deflate", tile=64),
        "packbits": lambda: corpus.encode(rgb, "packbits"),
        "planar_orient3": lambda: corpus.encode(rgb, "raw", planar=True,
                                                orientation=3),
    }[kind]()
    unknown = corpus.tiff_file({**corpus.tags_for(8, 8, 3, 8, 2),
                                259: 32766}, [bytes(192)])
    twin = encode_ppm(torch_pillow_corpus.pillow_decode(data))
    with JaxClient(port=jax_srv.port) as c:
        want = c.detect(data)
        bad_want = [c.detect(unknown), c.detect(data[:-100])]
    monkeypatch.setitem(sys.modules, "PIL", None)
    with DetectionClient(port=port_srv.port) as c:
        got = c.detect(data)
        got_twin = c.detect(twin)
        bad_got = [c.detect(unknown), c.detect(data[:-100])]
    assert got["detections"], "degenerate test: no detections at conf 0.01"
    assert got == got_twin
    _agree(got, want)
    for w, g in zip(bad_want, bad_got):
        assert w["ok"] is False and g["ok"] is False
        assert "undecodable" in g["error"]


def test_undecodable_frame_fails_per_request(servers):
    port_srv, _, _ = servers
    with DetectionClient(port=port_srv.port) as c:
        c.send(b"definitely not an image")
        c.send(encode_ppm(_frame(3)))
        bad, good = c.recv(), c.recv()
    assert bad["ok"] is False and "undecodable" in bad["error"]
    assert good["ok"] is True


def test_stop_then_start():
    _, _, model = _model()
    server = DetectionServer(model, normalized_anchors(), image_size=64,
                             batch_size=2, max_wait_ms=5.0, **KW)
    data = encode_ppm(_frame(4, (64, 64)))
    for warmup in (True, False):
        server.start(warmup=warmup)
        try:
            with DetectionClient(port=server.port) as c:
                assert c.detect(data)["ok"] is True
        finally:
            server.stop()
    assert not any(t.is_alive() for t in server._threads)


def test_start_refuses_while_old_batcher_runs():
    _, _, model = _model()
    server = DetectionServer(model, normalized_anchors(), image_size=64,
                             batch_size=2, **KW)
    release = threading.Event()
    server._batcher = threading.Thread(target=release.wait, daemon=True)
    server._batcher.start()
    try:
        with pytest.raises(RuntimeError, match="still running"):
            server.start(warmup=False)
    finally:
        release.set()
        server._batcher.join(timeout=5)


def test_cli_serves_npz_weights(tmp_path):
    """cli/serve.py's --weights path: an npz of torch-layout (unfolded)
    weights, folded by the CLI, served on the CPU."""
    from yolov5m_tpu_torch.cli import serve

    model = YOLOv5(first_out=16, nc=3, depth_mult=0.33)
    path = tmp_path / "w.npz"
    np.savez(path, **{k: v.numpy() for k, v in model.state_dict().items()
                      if not k.endswith("num_batches_tracked")})
    opt = serve.arg_parser(["--weights", str(path), "--nc", "3", "--model",
                            "n", "--image_size", "64", "--bs", "2",
                            "--port", "0", "--device", "cpu"])
    server = serve.build_server(opt)
    assert server.compute_dtype == torch.bfloat16
    with server, DetectionClient(port=server.port) as c:
        resp = c.detect(encode_ppm(_frame(5, (48, 64))))
    assert resp["ok"] is True and (resp["height"], resp["width"]) == (48, 64)


def test_cli_serves_a_train_checkpoint_and_weights_win(tmp_path):
    """cli/serve.py --checkpoint: a checkpoint of the port's train CLI
    serves its EMA weights (with the live BN statistics); --weights, given
    as well, wins, as in cli/detect.py."""
    from yolov5m_tpu_torch.cli import serve
    from yolov5m_tpu_torch.config import ANCHORS, Config
    from yolov5m_tpu_torch.train.loss import LossConfig, YoloLoss
    from yolov5m_tpu_torch.train.trainer import Trainer, YoloAdam
    from yolov5m_tpu_torch.utils.checkpoint import save_checkpoint

    torch.manual_seed(2)
    model = YOLOv5(first_out=8, nc=3, depth_mult=0.33)
    trainer = Trainer(model, YoloLoss(LossConfig(nc=3, image_size=64),
                                      np.asarray(ANCHORS, np.float32)),
                      YoloAdam(model.parameters(), Config(nc=3)))
    with torch.no_grad():
        torch._foreach_mul_(trainer.ema, 0.5)      # EMA != parameters
    ckpt = save_checkpoint(trainer.state_dict(), str(tmp_path), "model_1", 1)
    other = YOLOv5(first_out=8, nc=3, depth_mult=0.33)
    npz = tmp_path / "w.npz"
    np.savez(npz, **{k: v.numpy() for k, v in other.state_dict().items()})
    base = ["--nc", "3", "--model", "n", "--first_out", "8", "--image_size",
            "64", "--bs", "2", "--port", "0", "--device", "cpu", "--no_fuse"]
    server = serve.build_server(serve.arg_parser(base + ["--checkpoint",
                                                         ckpt]))
    want = {k: v.to(torch.bfloat16) for k, v in
            trainer.eval_state_dict().items()}
    got = server.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())
    with server, DetectionClient(port=server.port) as c:
        assert c.detect(encode_ppm(_frame(6, (64, 64))))["ok"] is True
    both = serve.build_server(serve.arg_parser(
        base + ["--checkpoint", ckpt, "--weights", str(npz)]))
    got = both.model.state_dict()
    assert all(torch.equal(got[k], v.to(torch.bfloat16))
               for k, v in other.state_dict().items())


@pytest.mark.parametrize("flags", (["--nc", "2"], ["--model", "s"],
                                   ["--first_out", "16"]))
def test_cli_without_weights_serves_a_random_init_off_the_flagship_shape(
        flags, capsys):
    """No --weights or --checkpoint, and a model the flagship blob does not
    fit: the seeded random init serves, with the JAX CLI's warning."""
    from yolov5m_tpu_torch.cli import serve
    from yolov5m_tpu_torch.models.fuse import fold_batchnorm
    from yolov5m_tpu_torch.models.yolo import FAMILY

    opt = serve.arg_parser(flags + ["--device", "cpu", "--bs", "2",
                                    "--image_size", "64", "--port", "0"])
    server = serve.build_server(opt)
    assert "WARNING: no --checkpoint/--weights given; using random init" \
        in capsys.readouterr().out
    fo, dm = FAMILY[opt.model]
    torch.manual_seed(0)
    want = fold_batchnorm(YOLOv5(first_out=opt.first_out or fo, nc=opt.nc,
                                 depth_mult=dm).state_dict())
    got = server.model.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], v.to(torch.bfloat16))
               for k, v in want.items())
    if opt.model == "s":
        with server, DetectionClient(port=server.port) as c:
            resp = c.detect(encode_ppm(_frame(7, (48, 64))))
        assert resp["ok"] is True and (resp["height"], resp["width"]) == \
            (48, 64)


def test_cli_without_weights_serves_the_flagship_at_its_shape(capsys):
    from yolov5m_tpu_torch.cli import serve
    from yolov5m_tpu_torch.models.weights import load_flagship

    server = serve.build_server(serve.arg_parser(
        ["--device", "cpu", "--bs", "2", "--image_size", "64", "--nc", "80",
         "--model", "m"]))
    assert "WARNING" not in capsys.readouterr().out
    want, _ = load_flagship(fold=True, device="cpu")
    got = server.model.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], v.to(torch.bfloat16))
               for k, v in want.items())
