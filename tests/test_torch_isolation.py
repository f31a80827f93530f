"""The port stands alone: no module of yolov5m_tpu_torch/ and not
chip_smoke.py imports jax, flax, optax, msgpack, the JAX package,
matplotlib or freetype (an AST scan); PIL, cv2 and yaml, which the card's
machine lacks, only behind an ImportError guard; the host
augmentation imports neither cv2 nor PIL, and it and the JPEG, PNG, WebP
and PNM (P1-P6, Pf) decode run with both made unimportable; the host
library builds from every C++ source of csrc/, none of which includes a
codec library's header; and the default entry points refuse to run on the
CPU when no GPU is present."""

import ast
import os
import re
import sys

import pytest
import torch

import chip_smoke
from yolov5m_tpu_torch import config
from yolov5m_tpu_torch.cli import detect, export, serve, train
from yolov5m_tpu_torch.models import weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "flax", "optax", "msgpack", "yolov5m_tpu", "jaxlib",
             "matplotlib", "freetype"}
GUARDED = {"PIL", "cv2", "yaml"}


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "yolov5m_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imports(tree):
    """(top-level module name, node) for every import in the tree."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node


def _guarded_by_import_error(tree, target):
    for node in ast.walk(tree):
        if isinstance(node, ast.Try) and any(
                n is target for stmt in node.body for n in ast.walk(stmt)):
            return any(isinstance(h.type, ast.Name)
                       and h.type.id == "ImportError" for h in node.handlers)
    return False


def test_port_files_found():
    names = {os.path.relpath(f, REPO) for f in _port_files()}
    assert "chip_smoke.py" in names
    assert os.path.join("yolov5m_tpu_torch", "ops", "nms.py") in names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for name, node in _imports(tree):
        assert name not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"
        if name in GUARDED:
            assert _guarded_by_import_error(tree, node), \
                f"{path}:{node.lineno}: {name} only behind an ImportError guard"


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="CUDA"):
        config.require_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        weights.load_flagship()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build_server(serve.arg_parser([]))
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(train.arg_parser(["--data", "synth", "--nosaveimgs"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        detect.main(detect.arg_parser(["--img", "x.ppm"]))
    assert config.require_device("cpu").type == "cpu"


@pytest.mark.parametrize("cli", [detect, export, serve, train],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_every_cli_defaults_to_the_card(cli):
    assert cli.arg_parser([]).device == "cuda"


def test_chip_smoke_fails_without_gpu(no_gpu, capsys):
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_augment_imports_neither_cv2_nor_pil():
    path = os.path.join(REPO, "yolov5m_tpu_torch", "data", "augment.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    assert not {name for name, _ in _imports(tree)} & {"cv2", "PIL"}


def test_augment_and_decode_run_without_cv2_or_pil(monkeypatch, tmp_path):
    import numpy as np

    from tests import torch_png_corpus, torch_webp_corpus
    from yolov5m_tpu_torch.data import augment, native

    webp_pixels = np.random.default_rng(1).integers(0, 256, (6, 5, 3)).astype(
        np.uint8)
    webp = torch_webp_corpus.pil(webp_pixels, lossless=True)
    for name in ("cv2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (48, 40, 3)).astype(np.float32)
    lab = np.asarray([[1, 0.5, 0.5, 0.3, 0.4]], np.float32)
    augment.reset_calls()
    out, _ = augment.TrainAugment(seed=0, rotate_p=1, blur_p=1, clahe_p=1)(
        img, lab, 1, rng=rng)
    augment.augment_hsv(out, rng)
    augment.mosaic4([(img, lab)] * 4, 32, rng)
    assert all(augment.calls.values())
    pixels = rng.integers(0, 256, (6, 5, 3)).astype(np.uint8)
    files = {"a.ppm": native.encode_ppm(pixels),
             "a.png": torch_png_corpus.encode(pixels, 8, 2)}
    with open(os.path.join(REPO, "tests", "fixtures", "torch_jpeg_corpus",
                           "scene_640x480.jpg"), "rb") as f:
        files["a.jpg"] = f.read()
    files["a.webp"] = webp
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        got = native.load_image_rgb(str(tmp_path / name))
        assert got.shape == native.decode_image(data).shape
        assert native.read_image_size(str(tmp_path / name)) == got.shape[:2]
        if name != "a.jpg":
            np.testing.assert_array_equal(
                got, webp_pixels if name == "a.webp" else pixels)


def test_pnm_decodes_without_cv2_or_pil(monkeypatch, tmp_path):
    """P1-P6 and Pf decode on every route, and their sizes read, with PIL
    and cv2 unimportable."""
    import numpy as np

    from tests import torch_pnm_corpus as corpus
    from yolov5m_tpu_torch.data import native

    for name in ("cv2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (5, 7, 3))
    grey = rgb.sum(-1) // 3
    ink = rng.integers(0, 2, (5, 7))                # 1 is black
    h = lambda magic, *more: corpus.header(magic, 7, 5, *more)
    files = {
        "a.pbm": (h(b"P1") + corpus.plain(ink), 255 * (1 - ink)),
        "b.pgm": (h(b"P2", 255) + corpus.plain(grey), grey),
        "c.ppm": (h(b"P3", 255) + corpus.plain(rgb), rgb),
        "d.pbm": (h(b"P4") + corpus.bits(ink), 255 * (1 - ink)),
        "e.pgm": (h(b"P5", 255) + corpus.binary(grey, 255), grey),
        "f.ppm": (h(b"P6", 255) + corpus.binary(rgb, 255), rgb),
        "g.pfm": (corpus.pfm(grey.astype(np.float32) + 0.5, b"-1.0"), grey),
    }
    for name, (data, want) in files.items():
        if want.ndim == 2:
            want = np.repeat(want[..., None], 3, axis=2)
        path = str(tmp_path / name)
        (tmp_path / name).write_bytes(data)
        for got in (native.decode_image(data), native.load_image_rgb(path),
                    native.load_image_pillow(path)):
            np.testing.assert_array_equal(got, want, err_msg=name)
        assert native.read_image_size(path) == (5, 7)


def test_tiff_decodes_without_cv2_or_pil(monkeypatch, tmp_path):
    """Uncompressed, PackBits, LZW (with predictor 2, and old-style),
    deflate in tiles and planar TIFF decode on every route, and their
    sizes read (Orientation 6 swapping them), with PIL and cv2
    unimportable."""
    import numpy as np

    from tests import torch_tiff_corpus as corpus
    from yolov5m_tpu_torch.data import native

    for name in ("cv2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)
    rgb = np.random.default_rng(3).integers(0, 256, (21, 37, 3), np.uint8)
    files = {
        "a.tif": corpus.encode(rgb, "raw", rows_per_strip=5),
        "b.tif": corpus.encode(rgb, "packbits"),
        "c.tif": corpus.encode(rgb, "lzw", predictor=2, rows_per_strip=4),
        "d.tif": corpus.tiff_file(corpus.tags_for(37, 21, 3, 8, 2, 5),
                                  [corpus.lzw(rgb.tobytes(), old=True)]),
        "e.tif": corpus.encode(rgb, "deflate", tile=16),
        "f.tif": corpus.encode(rgb, "lzw", planar=True),
        "g.tif": corpus.encode(rgb, "deflate", orientation=6),
    }
    for name, data in files.items():
        want = rgb.swapaxes(0, 1)[:, ::-1] if name == "g.tif" else rgb
        path = str(tmp_path / name)
        (tmp_path / name).write_bytes(data)
        for got in (native.decode_image(data), native.load_image_rgb(path),
                    native.load_image_pillow(path)):
            np.testing.assert_array_equal(got, want, err_msg=name)
        assert native.read_image_size(path) == want.shape[:2]


def test_host_library_needs_no_codec_library():
    """The host library's build takes every C++ source of csrc/ (the CUDA
    kernel builds apart), and none includes the header of libjpeg, libpng,
    zlib, giflib, libwebp or libtiff: the decoders are the port's own."""
    from yolov5m_tpu_torch.data import native

    csrc = os.path.join(REPO, "yolov5m_tpu_torch", "csrc")
    sources = sorted(os.path.join(csrc, n) for n in os.listdir(csrc)
                     if n.endswith(".cc"))
    assert os.path.join(csrc, "webp_decode.cc") in sources
    assert os.path.join(csrc, "tiff_decode.cc") in sources
    assert sorted(native._sources()) == sources
    for path in sources:
        with open(path) as f:
            includes = re.findall(r'#include\s*[<"]([^>"]+)', f.read())
        assert not [i for i in includes if re.match(
            r"(jpeglib|jerror|png|zlib|gif_lib|webp/|tiff)", i)], path
