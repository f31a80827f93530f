"""The port's native host library (yolov5m_tpu_torch/csrc/preprocess.cc,
bound in data/native.py) against the JAX package's (native/preprocess.cc
through yolov5m_tpu/data/native.py).

Both are built with the same g++ flags from the same resize code, so the
resize and the letterbox must be EXACTLY equal; the port decodes JPEG
with its own decoder (csrc/jpeg_decode.cc, no libjpeg) and JAX with
libjpeg, so decoded pixels and header sizes must be exactly equal on
PIL-encoded RGB, grayscale and progressive JPEGs at quality 75 and 95 and
on a file cut mid-scan, and corrupt or truncated buffers give None on
both sides (tests/test_torch_jpeg.py holds the decoder to JAX's on a
whole corpus). The numpy resize, the plain version, stays within one code
of the C path. Also: one build, linking no libjpeg (a compiler error
raises), the warning of a failed build, and the committed JPEG fixtures
(tests/torch_jpeg_fixtures.py)."""

import io
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

from tests import torch_jpeg_fixtures
from yolov5m_tpu.data import native as jax_native
from yolov5m_tpu_torch.data import native

torch.set_num_threads(1)


def _jpeg(arr, mode="RGB", **kw):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _image(seed, hw, channels=3):
    """Noise with flat rectangles: edges for the resize to move."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (*hw, channels), np.uint8)
    for _ in range(4):
        y, x = rng.integers(0, hw[0] // 2), rng.integers(0, hw[1] // 2)
        img[y:y + hw[0] // 3, x:x + hw[1] // 3] = rng.integers(0, 256,
                                                               channels)
    return img


def test_library_builds_with_libjpeg():
    """The library builds with the port's JPEG decoder in it and links no
    libjpeg: both sources on one g++ line, JAX's flags."""
    assert native.native_available() and native.jpeg_available()
    command = native.build_command.split()
    assert command[1:7] == list(native.CXX_FLAGS)
    assert command[-2:] == [native.SOURCE, native.JPEG_SOURCE]
    assert "-ljpeg" not in command and not any(
        a.startswith("-l") for a in command)
    lib = native.build()
    assert hasattr(lib, "decode_jpeg_u8") and hasattr(lib, "jpeg_dims")


@pytest.mark.parametrize("src_hw,dst_wh", [
    ((48, 80), (64, 40)), ((100, 52), (31, 67)), ((333, 517), (640, 412)),
    ((480, 640), (512, 384)), ((540, 960), (640, 360)), ((7, 5), (96, 128)),
])
def test_resize_exactly_equals_jax(src_hw, dst_wh):
    img = _image(1, src_hw)
    got = native.resize_bilinear(img, dst_wh)
    want = jax_native.resize_bilinear(img, dst_wh)
    assert got.shape == (dst_wh[1], dst_wh[0], 3)
    np.testing.assert_array_equal(got, want)
    plain = native.resize_bilinear_plain(img, dst_wh)
    assert np.abs(plain.astype(np.int16) - got).max() <= 1


@pytest.mark.parametrize("fill", (114, 0, 255))
@pytest.mark.parametrize("src_hw,dst", [
    ((480, 640), (640, 640)), ((540, 960), (640, 640)), ((333, 517), (64, 64)),
    ((100, 52), (96, 160)), ((640, 640), (640, 640)),
])
def test_letterbox_exactly_equals_jax(src_hw, dst, fill):
    img = _image(2, src_hw)
    got, ratio, dwdh = native.letterbox(img, dst, fill=fill)
    want, j_ratio, j_dwdh = jax_native.letterbox(img, dst, fill=fill)
    assert (ratio, dwdh) == (j_ratio, j_dwdh)
    np.testing.assert_array_equal(got, want)
    plain, p_ratio, p_dwdh = native.letterbox_plain(img, dst, fill=fill)
    assert (p_ratio, p_dwdh) == (ratio, dwdh)
    assert np.abs(plain.astype(np.int16) - got).max() <= 1


def test_grayscale_and_scaleup_take_the_plain_path():
    gray = _image(3, (40, 30), 1)[..., 0]
    out, _, _ = native.letterbox(gray, (64, 64))
    want, _, _ = native.letterbox_plain(gray, (64, 64))
    assert out.shape == (64, 64)
    np.testing.assert_array_equal(out, want)
    img = _image(4, (40, 30))
    got = native.letterbox(img, (64, 64), scaleup=False)
    assert got[1] == (1.0, 1.0)
    np.testing.assert_array_equal(got[0], jax_native.letterbox(
        img, (64, 64), scaleup=False)[0])


JPEG_CASES = {
    "rgb_q95": ("RGB", dict(quality=95)),
    "rgb_q75": ("RGB", dict(quality=75)),
    "gray_q95": ("L", dict(quality=95)),
    "gray_q75": ("L", dict(quality=75)),
    "progressive_q95": ("RGB", dict(quality=95, progressive=True)),
    "progressive_q75": ("RGB", dict(quality=75, progressive=True)),
}


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_decode_jpeg_and_dims_exactly_equal_jax(case, tmp_path):
    mode, kw = JPEG_CASES[case]
    arr = _image(5, (37, 53), 1 if mode == "L" else 3)
    data = _jpeg(arr[..., 0] if mode == "L" else arr, mode, **kw)
    got = native.decode_jpeg(data)
    want = jax_native.decode_jpeg(data)
    assert got is not None and got.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    assert native.jpeg_dims(data) == (37, 53)
    path = tmp_path / "a.jpg"
    path.write_bytes(data)
    np.testing.assert_array_equal(native.decode_jpeg(str(path)), want)
    np.testing.assert_array_equal(native.load_image_rgb(str(path)), want)
    np.testing.assert_array_equal(native.decode_image(data), want)
    assert native.jpeg_dims(str(path)) == native.read_image_size(str(path)) \
        == (37, 53)


def test_corrupt_and_truncated_jpeg_give_none():
    truncated = _jpeg(np.random.default_rng(6).integers(
        0, 255, (64, 64, 3), np.uint8))[:40]
    for data in (b"\xff\xd8 not actually a jpeg", b"PNG-ish junk",
                 truncated):
        assert native.decode_jpeg(data) is None
        assert jax_native.decode_jpeg(data) is None
        assert native.jpeg_dims(data) is None
    assert native.decode_image(truncated) is None


def test_jpeg_size_read_past_a_long_header(tmp_path):
    """A JPEG whose header segments outrun the first read: the size comes
    from the whole file."""
    arr = _image(7, (20, 30))
    data = _jpeg(arr)
    comment = b"\xff\xfe" + (65000).to_bytes(2, "big") + bytes(64998)
    padded = data[:2] + comment + comment + data[2:]
    path = tmp_path / "long.jpg"
    path.write_bytes(padded)
    assert native.read_image_size(str(path)) == (20, 30)
    np.testing.assert_array_equal(native.load_image_rgb(str(path)),
                                  jax_native.decode_jpeg(padded))


def test_failed_build_warns_once_and_uses_numpy(monkeypatch):
    def broken():
        raise RuntimeError("g++ failed (1): no compiler here")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "build", broken)
    img = _image(8, (100, 52))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = native.resize_bilinear(img, (40, 70))
        box = native.letterbox(img, (64, 64))
        assert not native.native_available() and not native.jpeg_available()
    assert len(caught) == 1 and "numpy" in str(caught[0].message)
    np.testing.assert_array_equal(got, native.resize_bilinear_plain(
        img, (40, 70)))
    np.testing.assert_array_equal(box[0], native.letterbox_plain(
        img, (64, 64))[0])
    assert native.decode_jpeg(_jpeg(img)) is None
    # the decoders have no other version: decode_image raises naming the
    # compiler, where the library is missing, and does not fall to PIL
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.decode_image(_jpeg(img))


def test_jpeg_cut_mid_scan_decodes_and_equals_jax(tmp_path):
    """A file cut inside its scan decodes, as libjpeg decodes it: the MCU
    the data runs out in from zero bits, the rest mid-grey."""
    data = _jpeg(_image(9, (64, 80)), quality=90)
    cut = data[:len(data) * 2 // 3]
    got = native.decode_jpeg(cut)
    assert got is not None and got.shape == (64, 80, 3)
    np.testing.assert_array_equal(got, jax_native.decode_jpeg(cut))
    np.testing.assert_array_equal(got[-8:], 128)
    assert native.jpeg_dims(cut) == (64, 80)
    path = tmp_path / "cut.jpg"
    path.write_bytes(cut)
    np.testing.assert_array_equal(native.load_image_rgb(str(path)), got)
    assert native.read_image_size(str(path)) == (64, 80)


def test_other_compiler_errors_raise(monkeypatch, tmp_path):
    broken = tmp_path / "preprocess.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "SOURCE", str(broken))
    # the broken source alone: g++ fails on it at once, where the whole
    # library would take it half a minute of -O3 before failing
    monkeypatch.setattr(native, "_sources", lambda: (native.SOURCE,))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not os.listdir(tmp_path / "build")      # no temporary file left


_LOGGING_CXX = """#!/bin/sh
# a compiler that logs its call, takes a second, and writes its output
echo "$$" >> "$CXX_LOG"
sleep 1
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then : > "$2"; fi
  shift
done
"""

_BUILD_SCRIPT = """
import sys
from yolov5m_tpu_torch.data import native
native.CXX, native.BUILD_DIR = sys.argv[1], sys.argv[2]
print(native._compile())
"""


def test_concurrent_builds_run_the_compiler_once(tmp_path):
    """Two processes that build into a fresh build directory at the same
    moment run the compiler once: the second waits on the lock and loads
    the first one's library (a compiler that logs each call counts)."""
    cxx = tmp_path / "cxx.sh"
    cxx.write_text(_LOGGING_CXX)
    cxx.chmod(0o755)
    log = tmp_path / "calls.log"
    build = tmp_path / "build" / "lib"
    env = dict(os.environ, CXX_LOG=str(log))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [root, *filter(None, [os.environ.get("PYTHONPATH")])])
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_SCRIPT, str(cxx),
                               str(build)], env=env, stdout=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs[0] == outs[1] and os.path.isfile(outs[0])
    assert len(log.read_text().split()) == 1
    assert os.listdir(build) == [os.path.basename(outs[0])]


def test_jpeg_fixtures_remake_exactly_and_stay_near_their_sources(tmp_path):
    """The committed fixtures are what tests/torch_jpeg_fixtures.py makes;
    each decodes within a mean of 3 codes of its numpy source."""
    paths = torch_jpeg_fixtures.write(str(tmp_path))
    assert len(paths) == 6
    total = 0
    for i, path in enumerate(paths):
        committed = os.path.join(torch_jpeg_fixtures.FOLDER,
                                 torch_jpeg_fixtures.name(i))
        with open(path, "rb") as a, open(committed, "rb") as b:
            data = b.read()
            assert a.read() == data, committed
        total += len(data)
        src = torch_jpeg_fixtures.scene(i)
        assert native.read_image_size(committed) == src.shape[:2]
        diff = np.abs(native.load_image_rgb(committed).astype(np.int16) - src)
        assert diff.mean() <= 3.0
    assert total < 2 ** 20
