"""The port's decoders of what the JAX package hands to Pillow 12.1.0
(csrc/jpeg_decode.cc in its Pillow mode, csrc/bmp_decode.cc,
csrc/gif_decode.cc, bound in data/native.py) against the JAX package's
routes on the same bytes, with PIL unimportable for the port.

Every file of the committed corpus (tests/torch_pillow_corpus.py) gives,
bitwise, what each JAX route gives, or fails where it fails: the server's
``_decode_image`` and the loader's ``load_image_rgb`` (the port's
decode_image and load_image_rgb), detect ``--img``'s ``Image.open(...)
.convert("RGB")`` (load_image_pillow) and the size Pillow's open reads
(read_image_size). The committed digests, which chip_smoke.py holds the
port to on a machine without Pillow, equal the JAX routes here, and the
generator remakes the corpus byte for byte. Also: every cut of one file of
each kind; a lossless CMYK file holding every (c, k) pair; the JPEG
corpus of tests/torch_jpeg_corpus.py on detect --img's route (both
libjpegs' smoothing, Pillow's refusal of cut files), where the two modes
agree wherever the two libjpegs do; and a hypothesis sweep of CMYK, YCCK
and lossless JPEG, BMP and GIF files.
"""

import os
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from tests import torch_jpeg_corpus as jcorpus
from tests import torch_pillow_corpus as corpus
from yolov5m_tpu.data import native as jax_native
from yolov5m_tpu.serving.server import _decode_image
from yolov5m_tpu_torch.data import native

torch.set_num_threads(1)

DIGESTS = corpus.load()
NAMES = sorted(DIGESTS)


def _read(name: str, folder: str = corpus.FOLDER) -> bytes:
    with open(os.path.join(folder, name), "rb") as f:
        return f.read()


def _same(got, want) -> bool:
    if got is None or want is None:
        return got is None and want is None
    return got.shape == want.shape and np.array_equal(got, want)


def _or_none(call, *args):
    try:
        return call(*args)
    except Exception:
        return None


def _jax_routes(path: str, data: bytes) -> dict:
    """What each JAX route gives for a file (None where it fails)."""
    return {"loader": _decode_image(data),
            "load": _or_none(jax_native.load_image_rgb, path),
            "img": corpus.pillow_decode(data),
            "hw": corpus.pillow_size(data)}


def _port_routes(path: str, data: bytes) -> dict:
    size = _or_none(native.read_image_size, path)
    return {"loader": native.decode_image(data),
            "load": _or_none(native.load_image_rgb, path),
            "img": _or_none(native.load_image_pillow, path),
            "hw": None if size is None else list(size)}


def _no_pil(monkeypatch):
    for name in ("PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)


def _check(path: str, data: bytes, monkeypatch):
    want = _jax_routes(path, data)
    with monkeypatch.context() as m:
        _no_pil(m)
        got = _port_routes(path, data)
    for route in ("loader", "load", "img"):
        assert _same(got[route], want[route]), route
    assert got["hw"] == want["hw"]
    return got


@pytest.mark.parametrize("name", NAMES)
def test_corpus_file_equals_jax(name, monkeypatch):
    path = os.path.join(corpus.FOLDER, name)
    got = _check(path, _read(name), monkeypatch)
    if got["img"] is not None:
        assert got["img"].dtype == np.uint8 and \
            got["img"].shape == (*got["hw"], 3)


def test_committed_digests_equal_jax_here():
    """The digests chip_smoke.py holds the port to are the JAX routes'
    pixels on this machine, and the port's."""
    for name in NAMES:
        data = _read(name)
        assert DIGESTS[name] == corpus.reference(data), name
        loader = native.decode_image(data)
        img = _or_none(native.load_image_pillow,
                       os.path.join(corpus.FOLDER, name))
        assert (None if loader is None else corpus.digest(loader)) == \
            DIGESTS[name]["loader"], name
        assert (None if img is None else corpus.digest(img)) == \
            DIGESTS[name]["img"], name


def test_corpus_remakes_exactly():
    made = corpus.cases()
    assert sorted(made) == NAMES
    for name, data in made.items():
        assert data == _read(name), name
    files = [n for n in os.listdir(corpus.FOLDER) if n != corpus.DIGESTS]
    assert sorted(files) == NAMES
    assert sum(len(d) for d in made.values()) < 2_500_000


def test_corpus_covers_what_it_claims():
    """The refusals are where they are meant to be; the decoded files are
    Pillow's on both routes but the smoothing pins; the six scenes decode
    at 640x480; a cut CMYK file gives its size but no pixels."""
    refused = {n for n in NAMES if DIGESTS[n]["img"] is None}
    assert refused == {
        "cmyk_cut_96x64.jpg", "lossless_cut_37x53.jpg",
        "lossless_missing_scan_37x53.jpg", "lossless_sof11_37x53.jpg",
        "lossless_ycc_37x53.jpg", "bmp_bad_bitfields_37x53.bmp",
        "bmp_bits2_37x53.bmp", "bmp_cut_37x53.bmp",
        "bmp_jpeg_compression_37x53.bmp", "bmp_palette_300_37x53.bmp",
        "bmp_rle_short_37x53.bmp", "gif_bad_code_37x53.gif",
        "gif_codesize13_37x53.gif", "gif_cut_37x53.gif",
        "gif_early_end_37x53.gif", "gif_no_image_37x53.gif"}
    # the smoothing pins are progressive files libjpeg-turbo 2.1 decodes
    # for the loader and smooths otherwise; every other file is Pillow's
    # on both routes
    for name in NAMES:
        differ = DIGESTS[name]["loader"] != DIGESTS[name]["img"]
        assert differ == name.startswith("smooth_"), name
    scenes = [n for n in NAMES if "scene_" in n]
    assert len(scenes) == 6
    for name in scenes:
        assert DIGESTS[name]["hw"] == [480, 640] and DIGESTS[name]["img"]
    assert DIGESTS["cmyk_cut_96x64.jpg"]["hw"] == [64, 96]
    for name in NAMES:
        if name.startswith(("cmyk_", "ycck_", "lossless_", "scene_")) and \
                name.endswith(".jpg"):
            # none of these is decoded by libjpeg-turbo 2.1: the JAX loader
            # gives Pillow's pixels
            assert jax_native.decode_jpeg(_read(name)) is None, name


# one small file of each kind, every cut (the progressive one every third)
CUT_FILES = ["cmyk_420_37x53.jpg", "ycck_progressive_420_37x53.jpg",
             "lossless_psv4_37x53.jpg", "bmp_8_37x53.bmp",
             "bmp_rle4_37x53.bmp", "gif_interlaced_37x53.gif"]


@pytest.mark.parametrize("name", CUT_FILES)
def test_every_cut_equals_jax(name, tmp_path, monkeypatch):
    """None, or a raise, exactly where the JAX route fails; the same
    pixels where it decodes (Pillow refuses every cut JPEG and GIF)."""
    data = _read(name)
    step = 3 if "progressive" in name else 1
    path = str(tmp_path / name)
    for cut in range(1, len(data), step):
        piece = data[:cut]
        want_loader, want_img = _decode_image(piece), \
            corpus.pillow_decode(piece)
        with open(path, "wb") as f:
            f.write(piece)
        with monkeypatch.context() as m:
            _no_pil(m)
            assert _same(native.decode_image(piece), want_loader), cut
            assert _same(_or_none(native.load_image_pillow, path),
                         want_img), cut


def test_cmyk_conversion_over_every_c_k_pair(monkeypatch):
    """A lossless CMYK file holds every (c, k) pair in its first and last
    samples: the port's pixels equal Pillow's decode, and Pillow's
    CMYK -> RGB of the same samples read inverted ("CMYK;I")."""
    from PIL import Image

    data = _read("cmyk_all_pairs_256x256.jpg")
    x, y = np.meshgrid(np.arange(256), np.arange(256))
    stored = np.stack([x, 255 - x, x * 7 % 256, y], -1).astype(np.uint8)
    pairs = {(int(c), int(k)) for c, k in zip((255 - stored[..., 0]).ravel(),
                                              (255 - stored[..., 3]).ravel())}
    assert len(pairs) == 2 ** 16
    want = np.asarray(Image.fromarray(255 - stored, "CMYK").convert("RGB"))
    with monkeypatch.context() as m:
        _no_pil(m)
        got = native.decode_image(data)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, corpus.pillow_decode(data))


@pytest.mark.parametrize("name", sorted(jcorpus.load()))
def test_jpeg_corpus_on_the_pillow_route(name, monkeypatch):
    """detect --img's route over tests/torch_jpeg_corpus.py's files equals
    Image.open: libjpeg-turbo 3.1's smoothing of the unrefined scenes,
    Pillow's refusal of the files cut mid-scan, CMYK through Pillow; where
    both libjpegs agree, both of the port's modes give one array."""
    data = _read(name, jcorpus.FOLDER)
    want = corpus.pillow_decode(data)
    with monkeypatch.context() as m:
        _no_pil(m)
        got = native.decode_jpeg_pillow(data)
        plain = native.decode_jpeg(data)
    assert _same(got, want)
    if _same(jax_native.decode_jpeg(data), want):
        assert _same(plain, got)


def test_routes_differ_where_the_libjpegs_do():
    """The unrefined scenes: 2514 values apart between the two routes, each
    equal to its JAX route; cut files decode on the loader's route only."""
    for name in ("scene_unrefined_640x480.jpg",
                 "scene_unrefined_arith_640x480.jpg"):
        data = _read(name, jcorpus.FOLDER)
        old, new = native.decode_jpeg(data), native.decode_jpeg_pillow(data)
        assert int((old != new).sum()) == 2514
        np.testing.assert_array_equal(new, corpus.pillow_decode(data))
    cut = _read("cut_mid_scan_96x64.jpg", jcorpus.FOLDER)
    assert native.decode_image(cut) is not None
    assert native.decode_jpeg_pillow(cut) is None


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


_HEADER = jcorpus.pil(jcorpus.picture(71, 16, 24), quality=80)
_AFTER_SOI = _HEADER[2:]


@pytest.mark.parametrize("case", [
    b"\xff\xd8" + _segment(0xE0, b"JFIF\x00\x01") + _AFTER_SOI,
    b"\xff\xd8" + _segment(0xEE, b"Adobe\x00") + _AFTER_SOI,
    b"\xff\xd8" + _segment(0xED, b"Photoshop 3.0\x00" + b"8BIM\x04\x04")
    + _AFTER_SOI,
    b"\xff\xd8" + _segment(0xED, b"Photoshop 3.0\x00" + b"8BIM\x03\xed"
                             b"\x00\x00\x00\x00\x00\x04abcd") + _AFTER_SOI,
    b"\xff\xd8" + _segment(0xE2, b"ICC_PROFILE\x00\x01") + _AFTER_SOI,
    b"\xff\xd8" + _segment(0xE2, b"ICC_PROFILE\x00\x01\x01abc")
    + _AFTER_SOI,
    b"\xff\xd8\xff\x01" + _AFTER_SOI,             # TEM: no marker Pillow knows
    b"\xff\xd8\xff\xff\xff" + _AFTER_SOI[1:],      # fill bytes
    b"\xff\xd8\x00\x12" + _AFTER_SOI,              # junk after SOI
    b"\xff\xd8" + _segment(0xFE, b"") + _AFTER_SOI,
    b"\xff\xd8" + _segment(0xDB, b"\x00" + bytes(10)) + _AFTER_SOI,
    jcorpus.without_marker(_HEADER, 0xC0),         # a scan before any frame
    _HEADER[:_HEADER.index(b"\xff\xc0") + 12],     # a frame cut short
    corpus.patched(_HEADER, 0xC0, 9, 2),           # two components
    corpus.patched(_HEADER, 0xC0, 4, 12),          # 12-bit
    _HEADER,
])
def test_pillow_header_walk_equals_pillow(case):
    """pillow_jpeg_size reads a size exactly where Pillow's JPEG open
    does, and the same one."""
    data = bytes(case)
    assert native.pillow_jpeg_size(data) == (
        None if corpus.pillow_size(data) is None
        else tuple(corpus.pillow_size(data)))


@st.composite
def pillow_files(draw):
    """Bytes of a CMYK, YCCK or lossless JPEG, a BMP or a GIF, maybe cut."""
    kind = draw(st.sampled_from(["cmyk", "lossless", "bmp", "gif"]))
    h, w = draw(st.integers(1, 48)), draw(st.integers(1, 48))
    seed = draw(st.integers(0, 2 ** 16))
    if kind == "cmyk":
        hv = [draw(st.sampled_from([(1, 1), (2, 1), (2, 2), (1, 2)]))
              for _ in range(2)]
        samp = [*hv[0], 1, 1, 1, 1, *hv[1]]
        data = corpus.encode(jcorpus.picture(seed, h, w, 4),
                             draw(st.sampled_from([corpus.CMYK,
                                                   corpus.YCCK])),
                             samp, draw(st.integers(5, 100)),
                             progressive=draw(st.booleans()),
                             arithmetic=draw(st.booleans()),
                             restart=draw(st.sampled_from([0, 2])),
                             adobe=draw(st.sampled_from([-1, 0])))
    elif kind == "lossless":
        comps = draw(st.sampled_from([1, 3, 4]))
        pic = jcorpus.picture(seed, h, w, comps)
        space = {1: corpus.GRAY, 3: corpus.RGB, 4: corpus.CMYK}[comps]
        data = corpus.encode(pic[..., 0] if comps == 1 else pic, space,
                             [1] * (2 * comps), psv=draw(st.integers(1, 7)),
                             pt=draw(st.integers(0, 4)),
                             restart=w * draw(st.integers(0, 2)))
    elif kind == "bmp":
        bits = draw(st.sampled_from([1, 4, 8, 24, 32]))
        pic = jcorpus.picture(seed, h, w)
        if bits <= 8:
            idx = (pic[..., 0].astype(np.int32) % (1 << bits)).astype(
                np.uint8)
            table = jcorpus.picture(seed + 1, 1, 1 << bits)[0]
            data = corpus.bmp(corpus.bmp_rows(idx, bits), w, h, bits,
                              palette=corpus.bgrx(table))
        else:
            top = draw(st.booleans())
            data = corpus.bmp(corpus.bmp_rows(pic, bits, not top), w, h,
                              bits, header=draw(st.sampled_from([40, 108])),
                              top_down=top)
    else:
        bits = draw(st.integers(2, 8))
        idx = (jcorpus.picture(seed, h, w)[..., 0].astype(np.int32) %
               (1 << bits)).astype(np.uint8)
        table = jcorpus.picture(seed + 2, 1, 1 << bits)[0]
        data = corpus.gif(idx, table=table, bits=bits,
                          interlace=draw(st.booleans()),
                          clear_every=draw(st.sampled_from([0, 5, 40])))
    if draw(st.integers(0, 4)) == 0:
        data = data[:draw(st.integers(1, len(data)))]
    return data


@settings(max_examples=60, deadline=None, derandomize=True)
@given(data=pillow_files())
def test_random_files_equal_jax(data, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("f") / "f.img")
    with open(path, "wb") as f:
        f.write(data)
    want = _jax_routes(path, data)
    got = _port_routes(path, data)
    for route in ("loader", "load", "img"):
        assert _same(got[route], want[route]), route
    assert got["hw"] == want["hw"]
