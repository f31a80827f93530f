"""The port's JPEG decoder (yolov5m_tpu_torch/csrc/jpeg_decode.cc, bound in
data/native.py) against the JAX package's libjpeg decode
(yolov5m_tpu.data.native.decode_jpeg) on the same bytes.

Every file of the committed corpus (tests/torch_jpeg_corpus.py) decodes
bitwise equal to JAX's, gives None exactly where JAX's does, and reads the
header size libjpeg reads; the committed digests, which chip_smoke.py holds
the decoder to on a machine without libjpeg, still equal JAX's decode here,
and the generator remakes the corpus byte for byte. Also: every cut of a
baseline file (with and without restart markers) bitwise equal to JAX's;
a progressive file cut short decoding wherever JAX's does (not bitwise:
libjpeg smooths such files); frames libjpeg-turbo refuses (lossless,
12-bit) or this decoder refuses (arithmetic coding); PIL and the
ValueError behind a refused file; decodes on many threads at once; and a
hypothesis sweep of size, sampling, quality and progressive coding.
"""

import concurrent.futures as cf
import os
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from tests import torch_jpeg_corpus as corpus
from yolov5m_tpu.data import native as jax_native
from yolov5m_tpu_torch.data import native

torch.set_num_threads(1)

DIGESTS = corpus.load()
NAMES = sorted(DIGESTS)


def _read(name: str) -> bytes:
    with open(os.path.join(corpus.FOLDER, name), "rb") as f:
        return f.read()


def _same(got, want) -> bool:
    if got is None or want is None:
        return got is None and want is None
    return got.shape == want.shape and np.array_equal(got, want)


def _dims(data: bytes):
    hw = native.jpeg_dims(data)
    return None if hw is None else list(hw)


@pytest.mark.parametrize("name", NAMES)
def test_corpus_file_equals_jax(name):
    data = _read(name)
    want = jax_native.decode_jpeg(data)
    got = native.decode_jpeg(data)
    assert _same(got, want), name
    assert _dims(data) == corpus.jax_dims(data)
    if got is not None:
        assert got.shape == (*_dims(data), 3) and got.dtype == np.uint8


def test_committed_digests_equal_jax_here():
    """The digests chip_smoke.py holds the decoder to are JAX's decode
    on this machine."""
    for name in NAMES:
        data = _read(name)
        assert DIGESTS[name] == corpus.reference(data), name
        got = native.decode_jpeg(data)
        assert (None if got is None else corpus.digest(got)) == \
            DIGESTS[name]["sha256"], name


def test_corpus_remakes_exactly():
    made = corpus.cases()
    assert sorted(made) == NAMES
    for name, data in made.items():
        assert data == _read(name), name
    files = [n for n in os.listdir(corpus.FOLDER) if n.endswith(".jpg")]
    assert sorted(files) == NAMES
    assert sum(len(d) for d in made.values()) < 500_000


def test_corpus_covers_what_it_claims():
    """None exactly for the three refused files, the CMYK file's header
    read all the same; the files cut mid-scan decode, their last MCU row
    mid-grey."""
    refused = {n for n in NAMES if DIGESTS[n]["sha256"] is None}
    assert refused == {"cmyk_30x20.jpg", "cut_in_header.jpg",
                       "junk_after_soi.jpg"}
    assert DIGESTS["cmyk_30x20.jpg"]["hw"] == [20, 30]   # the header reads
    for name in ("cut_mid_scan_96x64.jpg", "cut_mid_scan_restart3_96x64.jpg"):
        img = native.decode_jpeg(_read(name))
        assert img.shape == (64, 96, 3)
        np.testing.assert_array_equal(img[-16:], 128)   # the last MCU row


@pytest.mark.parametrize("restart", (0, 3))
def test_every_cut_of_a_baseline_file_equals_jax(restart):
    data = corpus.cv2_jpeg(corpus.picture(20 + restart, 24, 40), 80, "420",
                           restart=restart)
    for cut in range(2, len(data) + 1):
        part = data[:cut]
        assert _same(native.decode_jpeg(part), jax_native.decode_jpeg(part)), \
            cut
        assert _dims(part) == corpus.jax_dims(part), cut


def test_progressive_cut_short_decodes_where_jax_does():
    """libjpeg smooths the blocks of a progressive file cut short, the port
    does not: the pixels may differ, the success may not."""
    data = corpus.pil(corpus.picture(30, 40, 56), quality=80,
                      progressive=True)
    equal = 0
    for cut in range(2, len(data) + 1, 3):
        got = native.decode_jpeg(data[:cut])
        want = jax_native.decode_jpeg(data[:cut])
        assert (got is None) == (want is None), cut
        equal += _same(got, want)
    assert equal > 0


def _patched(data: bytes, offset_from_sof: int, value: int) -> bytes:
    sof = data.index(b"\xff\xc0")
    out = bytearray(data)
    out[sof + offset_from_sof] = value
    return bytes(out)


@pytest.mark.parametrize("what,offset,value,jax_decodes", [
    ("lossless SOF3", 1, 0xC3, False),
    ("12-bit precision", 4, 12, False),
    ("arithmetic SOF9", 1, 0xC9, True),
])
def test_refused_frames(what, offset, value, jax_decodes):
    """Frames libjpeg-turbo 2.1 refuses give None on both sides; an
    arithmetic-coded frame header, which libjpeg decodes, gives None on
    the port's side only (an accepted difference), its size read alike."""
    data = _patched(corpus.pil(corpus.picture(31, 16, 24)), offset, value)
    assert native.decode_jpeg(data) is None, what
    assert (jax_native.decode_jpeg(data) is not None) == jax_decodes, what
    assert _dims(data) == corpus.jax_dims(data), what


def test_refused_file_goes_to_pil_or_raises(tmp_path, monkeypatch):
    """A JPEG the decoder refuses (CMYK) goes to PIL, as in JAX; where PIL
    is missing, load_image_rgb raises the ValueError naming the file."""
    from PIL import Image

    data = _read("cmyk_30x20.jpg")
    path = tmp_path / "cmyk.jpg"
    path.write_bytes(data)
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(native.decode_image(data), want)
    np.testing.assert_array_equal(native.load_image_rgb(str(path)),
                                  jax_native.load_image_rgb(str(path)))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="cmyk.jpg"):
        native.load_image_rgb(str(path))
    np.testing.assert_array_equal(
        native.load_image_rgb(os.path.join(corpus.FOLDER,
                                           "sampling_420_37x53.jpg")),
        jax_native.decode_jpeg(_read("sampling_420_37x53.jpg")))


def test_decodes_on_many_threads_at_once():
    """No shared state: 16 threads decoding the corpus over and over give
    the sequential results."""
    datas = [_read(n) for n in NAMES] * 4
    want = [native.decode_jpeg(d) for d in datas]
    with cf.ThreadPoolExecutor(16) as pool:
        got = list(pool.map(native.decode_jpeg, datas, timeout=120))
    assert all(_same(g, w) for g, w in zip(got, want))


@settings(max_examples=40, deadline=None, derandomize=True)
@given(h=st.integers(1, 96), w=st.integers(1, 96),
       sampling=st.sampled_from(sorted(corpus.SAMPLING)),
       quality=st.integers(1, 100), progressive=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_random_files_equal_jax(h, w, sampling, quality, progressive, seed):
    data = corpus.cv2_jpeg(corpus.picture(seed, h, w), quality, sampling,
                           progressive=progressive)
    got = native.decode_jpeg(data)
    assert got is not None and got.shape == (h, w, 3)
    assert _same(got, jax_native.decode_jpeg(data))
    assert native.jpeg_dims(data) == (h, w)
