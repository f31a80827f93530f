"""The port's JPEG decoder (yolov5m_tpu_torch/csrc/jpeg_decode.cc, bound in
data/native.py) against the JAX package's libjpeg decode
(yolov5m_tpu.data.native.decode_jpeg) on the same bytes.

Every file of the committed corpus (tests/torch_jpeg_corpus.py) decodes
bitwise equal to JAX's, gives None exactly where JAX's does, and reads the
header size libjpeg reads; the committed digests, which chip_smoke.py holds
the decoder to on a machine without libjpeg, still equal JAX's decode here,
and the generator remakes the corpus byte for byte. Also, bitwise equal to
JAX's: every cut of a baseline file, Huffman or arithmetic, with and
without restart markers; every third cut of a progressive file of either
coding and every 37th of the corpus's progressive files (libjpeg smooths
the blocks whose AC are not all known); the scene's arithmetic twins,
equal to the scene itself; the scene recoded with AC bands never refined,
a complete file libjpeg smooths; a SOF9 header over Huffman data. And:
frames libjpeg-turbo 2.1 refuses (lossless, 12-bit); the Pillow route
behind a refused file (CMYK decodes without PIL) and the ValueError behind
one every route refuses; an arithmetic file loaded without PIL; decodes on
many threads at once; and a hypothesis sweep of size, sampling, quality,
entropy coding, scan scripts and cuts, written through libjpeg
(tests/torch_jpeg_writer.c).
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


def _frame(data: bytes) -> int:
    """The SOFn marker code of a JPEG."""
    for i in range(2, len(data) - 1):
        if data[i] == 0xFF and 0xC0 <= data[i + 1] <= 0xCF and \
                data[i + 1] not in (0xC4, 0xCC):
            return data[i + 1]
    return -1


def test_corpus_covers_what_it_claims():
    """None exactly for the three refused files, the CMYK file's header
    read all the same; the Huffman files cut mid-scan decode, their last
    MCU row mid-grey, the arithmetic one decodes on from zero bytes; the
    arithmetic files are SOF9 and SOF10 (the progressive and unrefined
    ones), one with DAC conditioning L 2, U 5, Kx 10; the progressive
    Huffman files cut in a DC, an AC and a refinement scan decode; the scene's arithmetic twins decode to the scene's digest,
    its unrefined recodings to one digest of their own."""
    refused = {n for n in NAMES if DIGESTS[n]["sha256"] is None}
    assert refused == {"cmyk_30x20.jpg", "cut_in_header.jpg",
                       "junk_after_soi.jpg"}
    assert DIGESTS["cmyk_30x20.jpg"]["hw"] == [20, 30]   # the header reads
    for name in ("cut_mid_scan_96x64.jpg", "cut_mid_scan_restart3_96x64.jpg"):
        img = native.decode_jpeg(_read(name))
        assert img.shape == (64, 96, 3)
        np.testing.assert_array_equal(img[-16:], 128)   # the last MCU row
    img = native.decode_jpeg(_read("arith_cut_mid_scan_96x64.jpg"))
    assert (img[-16:] != 128).mean() > 0.9
    arith = {n for n in NAMES if "arith" in n}
    assert len(arith) == 12
    for name in arith:
        want = 0xCA if "progressive" in name or "unrefined" in name \
            else 0xC9
        assert _frame(_read(name)) == want, name
    # DAC for tables 0 and 1: DC U 5, L 2 (0x52), AC Kx 10
    assert b"\xff\xcc\x00\x0a\x00\x52\x10\x0a\x01\x52\x11\x0a" in \
        _read("arith_dac_37x53.jpg")
    for name in ("progressive_cut_dc_96x64.jpg",
                 "progressive_cut_ac_96x64.jpg",
                 "progressive_cut_refine_restart3_96x64.jpg"):
        assert _frame(_read(name)) == 0xC2 and DIGESTS[name]["sha256"], name
    scene = DIGESTS["scene_640x480.jpg"]["sha256"]
    assert DIGESTS["scene_arith_640x480.jpg"]["sha256"] == scene
    assert DIGESTS["scene_arith_progressive_640x480.jpg"]["sha256"] == scene
    unrefined = DIGESTS["scene_unrefined_640x480.jpg"]["sha256"]
    assert unrefined not in (None, scene)
    assert DIGESTS["scene_unrefined_arith_640x480.jpg"]["sha256"] == \
        unrefined


@pytest.mark.parametrize("restart,arithmetic", [
    pytest.param(0, False, id="0"), pytest.param(3, False, id="3"),
    pytest.param(0, True, id="arithmetic-0"),
    pytest.param(3, True, id="arithmetic-3")])
def test_every_cut_of_a_baseline_file_equals_jax(restart, arithmetic):
    """Arithmetic coding decodes on past the cut from zero bytes."""
    picture = corpus.picture(20 + restart, 24, 40)
    if arithmetic:
        data = corpus.encode(picture, 80, "420", arithmetic=True,
                             restart=restart)
    else:
        data = corpus.cv2_jpeg(picture, 80, "420", restart=restart)
    for cut in range(2, len(data) + 1):
        part = data[:cut]
        assert _same(native.decode_jpeg(part), jax_native.decode_jpeg(part)), \
            cut
        assert _dims(part) == corpus.jax_dims(part), cut


@pytest.mark.parametrize("arithmetic", (False, True),
                         ids=("huffman", "arithmetic"))
def test_progressive_cut_short_decodes_where_jax_does(arithmetic):
    """Every third cut of a progressive file bitwise equal to JAX's:
    libjpeg smooths the blocks whose AC are not all known, row by row with
    the precision of the scan that reached them."""
    picture = corpus.picture(30, 40, 56)
    if arithmetic:
        data = corpus.encode(picture, 80, progressive=True, arithmetic=True)
    else:
        data = corpus.pil(picture, quality=80, progressive=True)
    decoded = 0
    for cut in range(2, len(data) + 1, 3):
        got = native.decode_jpeg(data[:cut])
        assert _same(got, jax_native.decode_jpeg(data[:cut])), cut
        decoded += got is not None
    assert decoded > len(data) // 6


@pytest.mark.parametrize("name", [n for n in NAMES if n.startswith(
    ("progressive_", "restart3_progressive")) and "cut" not in n])
def test_progressive_corpus_cuts_equal_jax(name):
    """Every 37th cut from byte 200 of the corpus's progressive files."""
    data = _read(name)
    for cut in range(200, len(data), 37):
        assert _same(native.decode_jpeg(data[:cut]),
                     jax_native.decode_jpeg(data[:cut])), cut


@pytest.mark.parametrize("name", ["scene_arith_640x480.jpg",
                                  "scene_arith_progressive_640x480.jpg"])
def test_arithmetic_twins_equal_the_scene(name):
    """The scene's coefficients recoded with arithmetic coding, sequential
    and progressive: JAX and the port decode them to the scene's pixels."""
    scene = jax_native.decode_jpeg(_read("scene_640x480.jpg"))
    data = _read(name)
    assert _same(jax_native.decode_jpeg(data), scene)
    assert _same(native.decode_jpeg(data), scene)


@pytest.mark.parametrize("name", ["scene_unrefined_640x480.jpg",
                                  "scene_unrefined_arith_640x480.jpg"])
def test_unrefined_scene_is_smoothed(name):
    """A complete progressive file whose AC bands stop at Al 1: libjpeg
    smooths it, so the port's decode equals JAX's and differs, on many
    samples, from the IDCT of the same coefficients recoded as a
    sequential file (which is not smoothed)."""
    data = _read(name)
    got = native.decode_jpeg(data)
    assert _same(got, jax_native.decode_jpeg(data))
    plain = jax_native.decode_jpeg(corpus.transcode(data))
    assert (got != plain).mean() > 0.3


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
    """Frames libjpeg-turbo 2.1 refuses give None on both sides; a SOF9
    header over Huffman-coded data, which libjpeg decodes as arithmetic
    coding (overflows stop restart intervals), decodes bitwise alike; the
    size is read alike."""
    data = _patched(corpus.pil(corpus.picture(31, 16, 24)), offset, value)
    got = native.decode_jpeg(data)
    assert (got is not None) == jax_decodes, what
    assert _same(got, jax_native.decode_jpeg(data)), what
    assert _dims(data) == corpus.jax_dims(data), what


def test_refused_file_goes_to_pil_or_raises(tmp_path, monkeypatch):
    """A JPEG the 2.1 decode refuses (CMYK) goes the way JAX sends it to
    PIL: the port decodes it as Pillow does, with PIL missing too, equal
    to JAX's load_image_rgb; a file every route refuses (a 12-bit frame)
    raises the ValueError naming the file, where JAX raises too."""
    from PIL import Image

    data = _read("cmyk_30x20.jpg")
    path = tmp_path / "cmyk.jpg"
    path.write_bytes(data)
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(native.decode_image(data), want)
    np.testing.assert_array_equal(native.load_image_rgb(str(path)),
                                  jax_native.load_image_rgb(str(path)))
    twelve = tmp_path / "twelve.jpg"
    twelve.write_bytes(_patched(corpus.pil(corpus.picture(31, 16, 24)), 4,
                                12))
    with pytest.raises(Exception):
        jax_native.load_image_rgb(str(twelve))
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(native.load_image_rgb(str(path)), want)
    with pytest.raises(ValueError, match="twelve.jpg"):
        native.load_image_rgb(str(twelve))
    np.testing.assert_array_equal(
        native.load_image_rgb(os.path.join(corpus.FOLDER,
                                           "sampling_420_37x53.jpg")),
        jax_native.decode_jpeg(_read("sampling_420_37x53.jpg")))


def test_arithmetic_file_loads_without_pil(tmp_path, monkeypatch):
    """load_image_rgb takes an arithmetic file through the port's decoder
    where PIL is missing."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    for name in ("arith_420_37x53.jpg", "arith_progressive_gray_37x53.jpg"):
        np.testing.assert_array_equal(
            native.load_image_rgb(os.path.join(corpus.FOLDER, name)),
            jax_native.decode_jpeg(_read(name)))


def test_decodes_on_many_threads_at_once():
    """No shared state: 16 threads decoding the corpus over and over give
    the sequential results."""
    datas = [_read(n) for n in NAMES] * 4
    want = [native.decode_jpeg(d) for d in datas]
    with cf.ThreadPoolExecutor(16) as pool:
        got = list(pool.map(native.decode_jpeg, datas, timeout=120))
    assert all(_same(g, w) for g, w in zip(got, want))


@st.composite
def scan_scripts(draw, n_components: int):
    """A progressive scan script libjpeg writes: DC interleaved or not at
    some Al, then each component's AC in up to four bands, each sent at
    some Al and refined part of the way down, or (one in five) never
    sent; the DC refined part of the way too."""
    comps = tuple(range(n_components))
    dc_al = draw(st.integers(0, 2))
    scans = ([(comps, 0, 0, 0, dc_al)] if draw(st.booleans())
             else [((c,), 0, 0, 0, dc_al) for c in comps])
    for c in comps:
        edges = sorted(draw(st.sets(st.integers(2, 63), max_size=3)))
        for lo, end in zip([1, *edges], [*edges, 64]):
            if draw(st.integers(0, 4)) == 0:
                continue
            al = draw(st.integers(0, 3))
            scans.append(((c,), lo, end - 1, 0, al))
            for ah in range(al, al - draw(st.integers(0, al)), -1):
                scans.append(((c,), lo, end - 1, ah, ah - 1))
    for ah in range(dc_al, dc_al - draw(st.integers(0, dc_al)), -1):
        scans.append((comps, 0, 0, ah, ah - 1))
    return scans


@st.composite
def jpeg_files(draw):
    """(bytes, h, w, cut): a file written through libjpeg, and whether it
    was cut."""
    h, w = draw(st.integers(1, 96)), draw(st.integers(1, 96))
    sampling = draw(st.sampled_from([*sorted(corpus.SAMPLING), "gray"]))
    picture = corpus.picture(draw(st.integers(0, 2 ** 16)), h, w)
    if sampling == "gray":
        picture, sampling = picture[..., 0], "444"
    coding = draw(st.sampled_from(["baseline", "progressive", "script"]))
    scans = (draw(scan_scripts(1 if picture.ndim == 2 else 3))
             if coding == "script" else None)
    data = corpus.encode(picture, draw(st.integers(1, 100)), sampling,
                         progressive=coding == "progressive",
                         arithmetic=draw(st.booleans()),
                         restart=draw(st.sampled_from([0, 0, 1, 3])),
                         scans=scans)
    cut = draw(st.none() | st.integers(2, len(data)))
    return (data if cut is None else data[:cut]), h, w, cut is not None


@settings(max_examples=60, deadline=None, derandomize=True)
@given(case=jpeg_files())
def test_random_files_equal_jax(case):
    data, h, w, cut = case
    got = native.decode_jpeg(data)
    assert _same(got, jax_native.decode_jpeg(data))
    assert _dims(data) == corpus.jax_dims(data)
    if not cut:
        assert got is not None and got.shape == (h, w, 3)
        assert native.jpeg_dims(data) == (h, w)
