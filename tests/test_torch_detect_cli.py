"""The port's detect CLI (yolov5m_tpu_torch/cli/detect.py) against the JAX
package's on the same npz weights and image files, on the CPU.

The weights are the committed tiny trained fixture (first_out 8, nc 1,
depth 0.67, trained at 128 px on red rectangles), bridged to the
torch-layout npz both CLIs read with --weights. ``--all --save_pred``
must write a detections.json that matches the JAX CLI's: the same images,
the same classes in the same order, conf within 1e-4 and boxes within 0.05
px (the tolerance of tests/test_torch_serving.py). For the comparison both
CLIs run their model in f32 (the CLIs' bf16 convolutions round
differently in XLA and oneDNN) and the JAX letterbox resizes with the
port's numpy bilinear (its C library is held to one code elsewhere,
ROADMAP queue 3); the images are square and non-square PNG and PPM files,
the PPM ones read by the port only, and WebP files, some named .jpg. With
--int8 both CLIs quantize with JAX's calibration absmax
(``shared_calibration``) and are held to the same bounds.
"""

import argparse
import builtins
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import yolov5m_tpu.models as jmodels
from tests.torch_datasets import write_image
from yolov5m_tpu.cli import detect as jdetect
from yolov5m_tpu.data import native as jnative
from yolov5m_tpu.models import quantize as jquantize
from yolov5m_tpu_torch.cli import detect
from yolov5m_tpu_torch.data import native
from yolov5m_tpu_torch.models import quantize
from yolov5m_tpu_torch.models.weights import (_module_token_to_torch,
                                              state_dict_from_flax)
from yolov5m_tpu_torch.models.yolo import YOLOv5

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "tiny_trained_nc1.msgpack")
HW = 128
SHAPES = ((128, 128), (96, 160), (200, 120), (128, 128), (150, 150))


def _scene(rng, h, w):
    img = rng.uniform(0, 64, (h, w, 3)).astype(np.uint8)
    bw, bh = rng.uniform(0.3, 0.5, 2)
    x1, y1 = int(rng.uniform(0, 1 - bw) * w), int(rng.uniform(0, 1 - bh) * h)
    img[y1:y1 + int(bh * h), x1:x1 + int(bw * w)] = (230, 51, 51)
    return img


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("w")
    import jax
    template = jmodels.YOLOv5(first_out=8, nc=1).init(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)))
    with open(FIXTURE, "rb") as f:
        variables = serialization.from_bytes(
            {"params": template["params"],
             "batch_stats": template["batch_stats"]}, f.read())
    path = str(tmp / "tiny.npz")
    np.savez(path, **state_dict_from_flax(jax.device_get(variables)))
    return path


@pytest.fixture
def images(tmp_path):
    rng = np.random.default_rng(0)
    folder = tmp_path / "imgs"
    folder.mkdir()
    for i, (h, w) in enumerate(SHAPES):
        write_image(str(folder / f"s{i}.png"), _scene(rng, h, w), "png")
    return str(folder)


def _opt(weights, img_dir, out, *extra):
    return detect.arg_parser(["--weights", weights, "--img_dir", img_dir,
                              "--nc", "1", "--first_out", "8", "--model",
                              "m", "--image_size", str(HW), "--bs", "2",
                              "--conf", "0.1", "--out", out, "--device",
                              "cpu", *extra])


@pytest.fixture
def f32_clis(monkeypatch):
    """Both CLIs in f32, and the JAX letterbox with the port's resize."""
    real = jmodels.YOLOv5
    monkeypatch.setattr(jmodels, "YOLOv5",
                        lambda **kw: real(**{**kw, "dtype": jnp.float32}))
    monkeypatch.setattr(jnative, "resize_bilinear", native.resize_bilinear)
    monkeypatch.setattr(detect, "COMPUTE_DTYPE", torch.float32)


def _agree(got, want):
    assert sorted(got) == sorted(want)
    for name, dets in want.items():
        assert [d["class"] for d in got[name]] == [d["class"] for d in dets]
        for g, w in zip(got[name], dets):
            np.testing.assert_allclose(g["conf"], w["conf"], atol=1e-4)
            np.testing.assert_allclose(g["box_xyxy"], w["box_xyxy"],
                                       atol=0.05)
    assert all(want.values()), "degenerate test: an image without detections"


@pytest.mark.parametrize("fuse", [False, True], ids=["bn", "fused"])
def test_detections_json_matches_jax(fuse, weights, images, tmp_path,
                                     f32_clis):
    extra = ["--all", "--save_pred"] + (["--fuse"] if fuse else [])
    opt = _opt(weights, images, str(tmp_path / "port"), *extra)
    returned = detect.main(opt)
    jopt = argparse.Namespace(**{**vars(opt), "out": str(tmp_path / "jax")})
    jdetect.main(jopt)
    with open(tmp_path / "port" / "detections.json") as f:
        got = json.load(f)
    with open(tmp_path / "jax" / "detections.json") as f:
        want = json.load(f)
    assert got == returned
    _agree(got, want)
    assert len(os.listdir(tmp_path / "port")) == len(SHAPES) + 1


def test_ppm_and_single_image_modes(weights, images, tmp_path, f32_clis,
                                    capsys):
    want = detect.main(_opt(weights, images, str(tmp_path / "o"), "--all"))
    rng = np.random.default_rng(0)
    ppm_dir = tmp_path / "ppm"
    ppm_dir.mkdir()
    for i, (h, w) in enumerate(SHAPES):          # the same pixels as PPM
        write_image(str(ppm_dir / f"s{i}.ppm"), _scene(rng, h, w), "ppm")
    got = detect.main(_opt(weights, str(ppm_dir), str(tmp_path / "o"),
                           "--all"))
    assert {k.replace(".ppm", ".png"): v for k, v in got.items()} == want
    capsys.readouterr()
    opt = _opt(weights, images, str(tmp_path / "o"))
    opt.img = os.path.join(images, "s1.png")
    assert detect.main(opt) is None
    out = capsys.readouterr().out
    assert f"{len(want['s1.png'])} detections (original-image coords, " \
           "160x96)" in out
    opt.img = None                               # a random pick from the dir
    detect.main(opt)
    assert "random image:" in capsys.readouterr().out


def test_checkpoint_prefers_ema_and_weights_win(weights, images, tmp_path,
                                                f32_clis):
    with np.load(weights) as z:
        sd = {k: torch.from_numpy(z[k]) for k in z.files}
    model = YOLOv5(first_out=8, nc=1)
    model.load_state_dict(sd)
    noisy = {k: v + 0.05 if k.endswith("weight") else v for k, v in sd.items()}
    state = {"step": 3, "model": noisy,
             "ema": [sd[n] for n, _ in model.named_parameters()],
             "optimizer": {}, "accum": []}
    ckpt = str(tmp_path / "checkpoint_epoch_3.pt")
    torch.save(state, ckpt)
    want = detect.main(_opt(weights, images, str(tmp_path / "o"), "--all"))
    opt = _opt(weights, images, str(tmp_path / "o"), "--all")
    opt.weights, opt.checkpoint = None, ckpt
    assert detect.main(opt) == want             # the EMA, not "model"
    opt.weights, opt.checkpoint = weights, str(tmp_path / "missing.pt")
    assert detect.main(opt) == want             # --weights wins
    torch.save({"model": noisy}, ckpt)
    opt.weights, opt.checkpoint = None, ckpt
    with pytest.raises(SystemExit, match="unrecognized"):
        detect.main(opt)


@pytest.fixture
def shared_calibration(monkeypatch):
    """Both CLIs quantize with JAX's calibration absmax. The port's own,
    taken on the same images, must agree with it within rtol 1e-5 (f32
    convs summed in another order); handing JAX's values on makes the
    int8 parameters bitwise JAX's, since a scale one ulp away flips codes
    at rounding ties, and the flips spread down the chain (independently
    calibrated, the two CLIs' confs differ by up to 0.01)."""
    seen = []

    def jax_calib(*args, **kwargs):
        seen.append(real_jax(*args, **kwargs))
        return seen[-1]

    def port_calib(*args, **kwargs):
        got = real_port(*args, **kwargs)
        want = {".".join([_module_token_to_torch(t) for t in k[:-1]]
                         + [k[-1]]): v for k, v in seen.pop().items()}
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        return want

    real_jax = jquantize.collect_calibration_absmax
    real_port = quantize.collect_calibration_absmax
    monkeypatch.setattr(jquantize, "collect_calibration_absmax", jax_calib)
    monkeypatch.setattr(quantize, "collect_calibration_absmax", port_calib)
    return seen


@pytest.mark.parametrize("fuse", [False, True], ids=["bn", "fused"])
def test_int8_detections_json_matches_jax(fuse, weights, images, tmp_path,
                                          f32_clis, shared_calibration,
                                          capsys):
    """--all --int8: the chain model calibrated on the first 8 images of
    the directory (all 5 here) gives JAX's detections within the f32
    bounds of _agree (measured: conf within 3e-8, boxes within 8e-6 px)."""
    extra = ["--all", "--save_pred", "--int8"] + (["--fuse"] if fuse else [])
    opt = _opt(weights, images, str(tmp_path / "jax"), *extra)
    jdetect.main(opt)
    opt.out = str(tmp_path / "port")
    capsys.readouterr()
    returned = detect.main(opt)
    assert "==> int8 PTQ (calibrated on 5 images)" in capsys.readouterr().out
    assert not shared_calibration
    with open(tmp_path / "port" / "detections.json") as f:
        got = json.load(f)
    with open(tmp_path / "jax" / "detections.json") as f:
        want = json.load(f)
    assert got == returned
    _agree(got, want)


def test_single_image_reads_as_pillow(weights, tmp_path, f32_clis, capsys,
                                      monkeypatch):
    """detect --img reads every file as the JAX CLI's Image.open does: on
    the unrefined scene (libjpeg-turbo 3.1.3's smoothing, not the loader's
    2.1), the port without PIL prints the detections it prints for a PPM
    of Pillow's pixels, and JAX's; a JPEG cut mid-scan, which the loader's
    route decodes, raises on both sides."""
    import sys

    from tests import torch_jpeg_corpus, torch_pillow_corpus

    src = os.path.join(torch_jpeg_corpus.FOLDER,
                       "scene_unrefined_640x480.jpg")
    with open(src, "rb") as f:
        pixels = torch_pillow_corpus.pillow_decode(f.read())
    ppm = str(tmp_path / "scene.ppm")
    write_image(ppm, pixels, "ppm")
    opt = _opt(weights, str(tmp_path), str(tmp_path / "o"), "--conf",
               "0.001")
    opt.img = src
    jdetect.main(opt)
    want = _printed_rows(capsys.readouterr().out)
    cut = os.path.join(torch_jpeg_corpus.FOLDER, "cut_mid_scan_96x64.jpg")
    with pytest.raises(Exception):
        jdetect.main(argparse.Namespace(**{**vars(opt), "img": cut}))
    capsys.readouterr()
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert detect.main(opt) is None
    got = _printed_rows(capsys.readouterr().out)
    opt.img = ppm
    detect.main(opt)
    assert got == _printed_rows(capsys.readouterr().out)
    assert got == want and got, "degenerate test: no detection printed"
    opt.img = cut
    assert native.load_image_rgb(cut).shape == (64, 96, 3)
    with pytest.raises(ValueError, match="cut_mid_scan"):
        detect.main(opt)


@pytest.mark.parametrize("lossless", [False, True],
                         ids=["lossy", "lossless"])
def test_webp_files_match_jax_and_ppm_twins(lossless, weights, tmp_path,
                                            f32_clis, capsys, monkeypatch):
    """WebP files named .jpg, as scraped datasets hold them, over --all, and
    a .webp through --img: the port without PIL gives JAX's detections
    (which come from Pillow's decode), and exactly those of PPM twins of
    Pillow's pixels."""
    import sys

    from tests import torch_webp_corpus

    rng = np.random.default_rng(5)
    webp_dir, ppm_dir = tmp_path / "webp", tmp_path / "ppm"
    webp_dir.mkdir()
    ppm_dir.mkdir()
    for i, (h, w) in enumerate(SHAPES[:3]):
        data = torch_webp_corpus.pil(_scene(rng, h, w), lossless=lossless,
                                     quality=90)
        (webp_dir / f"w{i}.jpg").write_bytes(data)
        write_image(str(ppm_dir / f"w{i}.ppm"),
                    torch_webp_corpus.pillow_decode(data), "ppm")
    jdetect.main(_opt(weights, str(webp_dir), str(tmp_path / "jax"), "--all",
                      "--save_pred"))
    with open(tmp_path / "jax" / "detections.json") as f:
        want = json.load(f)
    twins = detect.main(_opt(weights, str(ppm_dir), str(tmp_path / "t"),
                             "--all"))
    single = _opt(weights, str(webp_dir), str(tmp_path / "o"))
    single.img = str(webp_dir / "w1.webp")
    (webp_dir / "w1.webp").write_bytes((webp_dir / "w1.jpg").read_bytes())
    jdetect.main(single)
    want_rows = _printed_rows(capsys.readouterr().out)
    (webp_dir / "w1.webp").unlink()
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = detect.main(_opt(weights, str(webp_dir), str(tmp_path / "port"),
                           "--all"))
    _agree(got, want)
    assert got == {k.replace(".ppm", ".jpg"): v for k, v in twins.items()}
    (webp_dir / "w1.webp").write_bytes((webp_dir / "w1.jpg").read_bytes())
    assert detect.main(single) is None
    got_rows = _printed_rows(capsys.readouterr().out)
    assert got_rows == want_rows and got_rows


def _printed_rows(out: str) -> list:
    """(class name, conf, box) of each detection line detect prints."""
    rows = re.findall(r"^ +(\S+) ([0-9.]+) \[(-?\d+), (-?\d+), (-?\d+), "
                      r"(-?\d+)\]$", out, re.M)
    return [(r[0], float(r[1]), [float(v) for v in r[2:]]) for r in rows]


def test_int8_single_image_matches_jax(weights, images, tmp_path, f32_clis,
                                       shared_calibration, capsys):
    """Single-image --int8 calibrates on the input image; the printed
    detections (conf to 3 places, boxes to the pixel) are JAX's."""
    opt = _opt(weights, images, str(tmp_path / "o"), "--int8")
    opt.img = os.path.join(images, "s1.png")
    jdetect.main(opt)
    want = capsys.readouterr().out
    assert detect.main(opt) is None
    got = capsys.readouterr().out
    assert "==> int8 PTQ (calibrated on the input image)" in got
    assert _printed_rows(got) == _printed_rows(want)
    assert _printed_rows(got), "degenerate test: no detection printed"


def test_refusals_exit_before_work(weights, images, tmp_path, monkeypatch,
                                   capsys):
    out = str(tmp_path / "o")
    empty = tmp_path / "empty"
    empty.mkdir()
    got = detect.main(_opt(weights, images, out, "--all", "--int8"))
    assert sorted(got) == sorted(os.listdir(images))    # --int8 runs
    with pytest.raises(SystemExit, match="no images"):
        detect.main(_opt(weights, str(empty), out, "--all", "--int8"))
    assert "calibrated on 0" not in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--img_dir"):
        detect.main(detect.arg_parser(["--all", "--device", "cpu"]))
    # a class name the images cannot draw stops --save_pred before any work
    with pytest.raises(SystemExit, match="'é'"):
        detect.main(_opt(weights, images, out, "--all", "--save_pred",
                         "--labels", "car,café"))
    assert not os.path.exists(out)


def _no_matplotlib(monkeypatch):
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)


def test_save_pred_without_matplotlib_equals_direct_render(
        weights, images, tmp_path, monkeypatch):
    """--all --save_pred writes its images with matplotlib unimportable,
    and each equals the port's renderer called on detect's own results."""
    from tests.torch_plot_cases import decode
    from yolov5m_tpu_torch.config import COCO_LABELS
    from yolov5m_tpu_torch.utils import plotting

    _no_matplotlib(monkeypatch)
    out = tmp_path / "o"
    results = detect.main(_opt(weights, images, str(out), "--all",
                               "--save_pred"))
    assert sorted(os.listdir(out)) == sorted(
        [n.replace(".png", "_pred.png") for n in os.listdir(images)]
        + ["detections.json"])
    for name, dets in results.items():
        rows = np.array([[COCO_LABELS.index(d["class"]), d["conf"],
                          *d["box_xyxy"]] for d in dets],
                        np.float32).reshape(-1, 6)
        raw = native.load_image_rgb(os.path.join(images, name))
        want = plotting.render_image(raw.astype(np.float32) / 255.0, rows,
                                     COCO_LABELS)
        got = decode(str(out / name.replace(".png", "_pred.png")))
        np.testing.assert_array_equal(got, want)
    assert any(results.values()), "degenerate test: no detection drawn"



def test_tiff_files_match_jax_and_ppm_twins(weights, tmp_path, f32_clis,
                                            capsys, monkeypatch):
    """TIFF that the JAX CLI hands to Pillow (LZW with predictor 2,
    deflate tiles, PackBits, planes under Orientation 6, 16-bit grey),
    named .jpg for both --all listings: the port without PIL gives JAX's
    detections, and exactly those of PPM twins of Pillow's pixels; --img
    on a .tif under Orientation 6 prints JAX's rows."""
    import sys

    from tests import torch_pillow_corpus
    from tests import torch_tiff_corpus as corpus

    rng = np.random.default_rng(8)
    makers = (lambda a: corpus.encode(a, "lzw", predictor=2),
              lambda a: corpus.encode(a, "deflate", tile=32),
              lambda a: corpus.encode(a, "packbits"),
              lambda a: corpus.encode(a, "raw", planar=True, orientation=6),
              lambda a: corpus.encode((a.astype(np.int64).sum(-1) // 3)
                                      .astype(np.uint16), "raw"))
    dirs = {k: tmp_path / k for k in ("tiff", "twins")}
    for d in dirs.values():
        d.mkdir()
    for i, ((h, w), make) in enumerate(zip(SHAPES, makers)):
        data = make(_scene(rng, h, w))
        (dirs["tiff"] / f"{i}.jpg").write_bytes(data)
        write_image(str(dirs["twins"] / f"{i}.ppm"),
                    torch_pillow_corpus.pillow_decode(data), "ppm")
    tif = tmp_path / "one.tif"
    tif.write_bytes(corpus.encode(_scene(rng, *SHAPES[1]), "lzw",
                                  orientation=6))
    jdetect.main(_opt(weights, str(dirs["tiff"]), str(tmp_path / "jo"),
                      "--all", "--save_pred", "--conf", "0.02"))
    with open(tmp_path / "jo" / "detections.json") as f:
        want = json.load(f)
    twins = detect.main(_opt(weights, str(dirs["twins"]), str(tmp_path / "t"),
                             "--all", "--conf", "0.02"))
    single = _opt(weights, str(dirs["tiff"]), str(tmp_path / "o"))
    single.img = str(tif)
    jdetect.main(single)
    want_rows = _printed_rows(capsys.readouterr().out)
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = detect.main(_opt(weights, str(dirs["tiff"]), str(tmp_path / "po"),
                           "--all", "--conf", "0.02"))
    assert got == {k.replace(".ppm", ".jpg"): v for k, v in twins.items()}
    _agree(got, want)
    single = _opt(weights, str(dirs["tiff"]), str(tmp_path / "o"))
    single.img = str(tif)
    assert detect.main(single) is None
    assert _printed_rows(capsys.readouterr().out) == want_rows and want_rows

def _pnm_files(rng) -> dict:
    """{name: (PNM bytes, Pillow's pixels)}: plain P3 at 255 and at maxval
    300, a 16-bit P5 and a P6 at maxval 1000, of SHAPES[:4]."""
    from tests import torch_pillow_corpus
    from tests import torch_pnm_corpus as corpus

    files = {}
    for i, (kind, (h, w)) in enumerate(zip(("p3", "p5_16bit", "p6_maxval1000",
                                            "p3_maxval300"), SHAPES)):
        rgb = _scene(rng, h, w).astype(np.int64)
        grey = rgb.sum(-1) // 3
        data = {
            "p3": corpus.header(b"P3", w, h, 255) + corpus.plain(rgb),
            "p5_16bit": corpus.header(b"P5", w, h, 65535) +
            corpus.binary(grey, 65535),
            "p6_maxval1000": corpus.header(b"P6", w, h, 1000) + corpus.binary(
                np.round(rgb * (1000 / 255)).astype(np.int64), 1000),
            "p3_maxval300": corpus.header(b"P3", w, h, 300) + corpus.plain(
                np.round(rgb * (300 / 255)).astype(np.int64)),
        }[kind]
        files[f"{i}_{kind}"] = (data,
                                torch_pillow_corpus.pillow_decode(data))
    return files


def test_pnm_files_match_jax_and_ppm_twins(weights, tmp_path, f32_clis,
                                           capsys, monkeypatch):
    """PNM that the JAX CLI hands to Pillow (plain P3 at 255 and at maxval
    300, a 16-bit P5, a P6 at maxval 1000), named .ppm for the port's
    --all and .jpg for JAX's, whose listing takes no .ppm: the port without
    PIL gives JAX's detections, and exactly those of P6 twins of Pillow's
    pixels; --img on the P3 and on the 16-bit P5 prints JAX's rows."""
    import sys

    files = _pnm_files(np.random.default_rng(6))
    dirs = {k: tmp_path / k for k in ("jax", "port", "twins")}
    for d in dirs.values():
        d.mkdir()
    for name, (data, pixels) in files.items():
        (dirs["jax"] / f"{name}.jpg").write_bytes(data)
        (dirs["port"] / f"{name}.ppm").write_bytes(data)
        write_image(str(dirs["twins"] / f"{name}.ppm"), pixels, "ppm")
    jdetect.main(_opt(weights, str(dirs["jax"]), str(tmp_path / "jo"),
                      "--all", "--save_pred"))
    with open(tmp_path / "jo" / "detections.json") as f:
        want = json.load(f)
    twins = detect.main(_opt(weights, str(dirs["twins"]), str(tmp_path / "t"),
                             "--all"))
    want_rows = {}
    for name in ("0_p3", "1_p5_16bit"):
        single = _opt(weights, str(dirs["port"]), str(tmp_path / "o"))
        single.img = str(dirs["port"] / f"{name}.ppm")
        jdetect.main(single)
        want_rows[name] = _printed_rows(capsys.readouterr().out)
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = detect.main(_opt(weights, str(dirs["port"]), str(tmp_path / "po"),
                           "--all"))
    assert got == twins
    _agree({k.replace(".ppm", ".jpg"): v for k, v in got.items()}, want)
    for name, rows in want_rows.items():
        single = _opt(weights, str(dirs["port"]), str(tmp_path / "o"))
        single.img = str(dirs["port"] / f"{name}.ppm")
        assert detect.main(single) is None
        assert _printed_rows(capsys.readouterr().out) == rows and rows
