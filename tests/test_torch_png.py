"""The port's PNG decoder (yolov5m_tpu_torch/csrc/png_decode.cc, inflated
by zlib in data/native.py) against Pillow, which the JAX package reads PNG
with (``np.asarray(Image.open(f).convert("RGB"))``): every file of the
committed corpus (tests/torch_png_corpus.py) decodes to the sha256 that
Pillow's decode gave, and is refused wherever Pillow refuses it; its header
gives the size Pillow's open reads. The same through decode_image,
load_image_rgb (a ValueError naming the file) and read_image_size; the
corpus as this Pillow decodes it now; many threads at once; and a
hypothesis sweep of files written by Pillow, by cv2 and by the corpus's
writer (every colour type, bit depth, filter, interlace and IDAT split),
whole and damaged (cut, a bit flipped, a byte dropped)."""

import io
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from PIL import Image

from tests import torch_png_corpus as corpus
from yolov5m_tpu_torch.data import native

torch.set_num_threads(1)

DIGESTS = corpus.load()
NAMES = sorted(DIGESTS)


def _read(name):
    with open(os.path.join(corpus.FOLDER, name), "rb") as f:
        return f.read()


def _port(data):
    img = native.decode_png(data)
    hw = native.png_dims(data)
    return {"sha256": None if img is None else corpus.digest(img),
            "hw": None if hw is None else list(hw)}


def test_corpus_covers_the_cases():
    assert len(NAMES) >= 90
    decoded = [n for n in NAMES if DIGESTS[n]["sha256"]]
    refused = [n for n in NAMES if not DIGESTS[n]["sha256"]]
    assert len(refused) >= 14 and len(decoded) >= 70
    for ctype, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)),
                          (3, (1, 2, 4, 8)), (4, (8, 16)), (6, (8, 16))):
        for depth in depths:
            for suffix in ("", "_adam7"):
                assert DIGESTS[f"type{ctype}_{depth}bit{suffix}_37x53.png"][
                    "sha256"]
    assert DIGESTS["scene_640x480.png"]["hw"] == [480, 640]


@pytest.mark.parametrize("name", NAMES)
def test_corpus_file_equals_pillow(name):
    assert _port(_read(name)) == DIGESTS[name]


@pytest.mark.parametrize("name", NAMES)
def test_corpus_file_through_the_loaders_entry_points(name, tmp_path):
    want = DIGESTS[name]
    path = tmp_path / name
    path.write_bytes(_read(name))
    img = native.decode_image(_read(name))
    assert (None if img is None else corpus.digest(img)) == want["sha256"]
    if want["sha256"] is None:
        with pytest.raises(ValueError, match=name):
            native.load_image_rgb(str(path))
    else:
        assert corpus.digest(native.load_image_rgb(str(path))) == \
            want["sha256"]
    if want["hw"] is None:
        with pytest.raises(ValueError, match=name):
            native.read_image_size(str(path))
    else:
        assert list(native.read_image_size(str(path))) == want["hw"]


def test_corpus_is_this_writers_and_this_pillows():
    """The committed files are what tests.torch_png_corpus writes, and
    Pillow here decodes them to the committed digests."""
    cases = corpus.cases()
    assert sorted(cases) == NAMES
    for name, data in cases.items():
        assert data == _read(name), name
        assert corpus.pillow(data) == DIGESTS[name], name


def test_pillow_conversion_rules():
    """The rules the decoder follows, read off the corpus: 16-bit grey
    clamps at 255, other 16-bit samples keep their high byte, 1/2/4-bit grey
    scale by 255/85/17, palette indices past the palette read black."""
    wide = native.decode_png(_read("type0_16bit_wide_11x9.png"))
    assert list(wide[0, :4, 0]) == [0, 255, 255, 255]
    for depth, scale in ((1, 255), (2, 85), (4, 17)):
        img = native.decode_png(_read(f"type0_{depth}bit_37x53.png"))
        assert set(np.unique(img)) <= set(range(0, 256, scale))
    short = native.decode_png(_read("palette_short_13x12.png"))
    idx = np.random.default_rng(31).integers(0, 16, (12, 13))
    assert (short[idx >= 10] == 0).all()
    assert (short[idx < 10] == np.arange(30, dtype=np.uint8).reshape(
        10, 3)[idx[idx < 10]]).all()


def test_threads_decode_at_once():
    datas = [_read(n) for n in NAMES if DIGESTS[n]["sha256"]] * 2
    with ThreadPoolExecutor(16) as pool:
        got = list(pool.map(native.decode_png, datas))
    for img, data in zip(got, datas):
        np.testing.assert_array_equal(img, native.decode_png(data))


def test_paths_and_other_formats():
    path = os.path.join(corpus.FOLDER, "scene_640x480.png")
    assert native.decode_png(path).shape == (480, 640, 3)
    assert native.png_dims(path) == (480, 640)
    jpeg = cv2.imencode(".jpg", np.zeros((4, 4, 3), np.uint8))[1].tobytes()
    assert native.decode_png(jpeg) is None and native.png_dims(jpeg) is None
    assert native.decode_png(b"") is None


MODES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
         (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@st.composite
def png_files(draw):
    """PNG bytes written by the corpus's writer, Pillow or cv2, whole or
    damaged."""
    h, w = draw(st.integers(1, 40)), draw(st.integers(1, 40))
    seed = draw(st.integers(0, 2 ** 16))
    rng = np.random.default_rng(seed)
    writer = draw(st.sampled_from(["corpus", "pillow", "cv2"]))
    if writer == "corpus":
        ctype, depth = draw(st.sampled_from(MODES))
        palette = None
        if ctype == 3:
            palette = rng.integers(0, 256, 3 * draw(st.integers(
                1, 1 << depth)), np.uint8).tobytes()
        sizes = draw(st.none() | st.lists(st.integers(0, 60), min_size=1,
                                          max_size=4).filter(any))
        data = corpus.encode(
            corpus.samples(seed, h, w, corpus.CHANNELS[ctype], depth), depth,
            ctype, draw(st.booleans()),
            tuple(draw(st.lists(st.integers(0, 4), min_size=1, max_size=5))),
            draw(st.integers(0, 9)),
            idat_sizes=None if sizes is None else tuple(sizes),
            palette=palette)
    elif writer == "pillow":
        mode = draw(st.sampled_from(["RGB", "L", "RGBA", "LA", "P", "1",
                                     "I;16"]))
        if mode == "I;16":
            im = Image.fromarray(rng.integers(0, 65536, (h, w)).astype(
                np.uint16))
        elif mode == "1":
            im = Image.fromarray(rng.integers(0, 2, (h, w)).astype(bool))
        else:
            im = Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(
                np.uint8))
            im = im.quantize(draw(st.integers(2, 256))) if mode == "P" \
                else im.convert(mode)
        buf = io.BytesIO()
        im.save(buf, "PNG", optimize=draw(st.booleans()),
                compress_level=draw(st.integers(0, 9)))
        data = buf.getvalue()
    else:
        dtype = draw(st.sampled_from([np.uint8, np.uint16]))
        arr = rng.integers(0, np.iinfo(dtype).max + 1,
                           (h, w, draw(st.sampled_from([1, 3, 4])))
                           ).astype(dtype)
        data = cv2.imencode(".png", arr, [cv2.IMWRITE_PNG_COMPRESSION,
                                          draw(st.integers(0, 9))])[1].tobytes()
    damage = draw(st.sampled_from([None, "cut", "flip", "drop"]))
    if damage is not None:
        i = draw(st.integers(8, len(data) - 1))
        data = bytearray(data)
        if damage == "cut":
            data = data[:i]
        elif damage == "flip":
            data[i] ^= 1 << draw(st.integers(0, 7))
        else:
            del data[i]
        data = bytes(data)
    return data


@settings(max_examples=300, deadline=None, derandomize=True)
@given(data=png_files())
def test_random_files_equal_pillow(data):
    assert _port(data) == corpus.pillow(data)


def test_no_pillow_needed(monkeypatch):
    """PNG decodes, and its size reads, with Pillow made unimportable."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    data = _read("type6_16bit_adam7_37x53.png")
    assert corpus.digest(native.decode_image(data)) == DIGESTS[
        "type6_16bit_adam7_37x53.png"]["sha256"]
    assert native.read_image_size(os.path.join(
        corpus.FOLDER, "scene_640x480.png")) == (480, 640)
    assert native.decode_image(_read("bad_crc_ihdr_31x24.png")) is None


@pytest.mark.parametrize("hw", [(1, 1), (5, 7), (48, 33), (480, 640)])
def test_chip_smokes_writer(hw):
    """chip_smoke.py's PNG writer (stdlib zlib, rows cycling through the
    five filters): Pillow and the port read back its pixels."""
    import chip_smoke

    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3)).astype(
        np.uint8)
    data = chip_smoke.encode_png(img)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), img)
    np.testing.assert_array_equal(native.decode_png(data), img)
