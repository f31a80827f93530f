"""The port's WebP decoder (csrc/webp_decode.cc, bound in data/native.py)
against the JAX package's routes, which hand WebP to Pillow 12.1.0 over
its bundled libwebp 1.6.0, on the same bytes, with PIL unimportable for
the port.

Every file of the committed corpus (tests/torch_webp_corpus.py) gives,
bitwise, what each JAX route gives, or fails where it fails: the server's
``_decode_image`` and the loader's ``load_image_rgb`` (the port's
decode_image and load_image_rgb), detect ``--img``'s ``Image.open(...)
.convert("RGB")`` (load_image_pillow) and the dataset's
``_read_image_size`` (read_image_size). The committed digests, which
chip_smoke.py holds the port to on a machine without Pillow, equal the JAX
routes here, and the generator remakes the corpus byte for byte. Also:
every cut of one lossy and one lossless file; a hypothesis sweep of files
from Pillow's writer (size, quality, method, lossless, alpha, exact) and
of the test writer's settings (loop filter, sharpness, partitions,
segments, alpha coding); the alpha the routes drop against Pillow's
RGBA; for each libwebp rule the corpus pins, the cases that fail when the
rule is mutated in the C.
"""

import io
import os
import sys
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from tests import torch_webp_corpus as corpus
from yolov5m_tpu.data import native as jax_native
from yolov5m_tpu.data.dataset import _read_image_size
from yolov5m_tpu.serving.server import _decode_image
from yolov5m_tpu_torch.data import formats, native

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


def _or_none(call, *args):
    try:
        return call(*args)
    except Exception:
        return None


def _jax_routes(path: str, data: bytes) -> dict:
    """What each JAX route gives for a file (None where it fails)."""
    size = _or_none(_read_image_size, path)
    return {"loader": _decode_image(data),
            "load": _or_none(jax_native.load_image_rgb, path),
            "img": corpus.pillow_decode(data),
            "hw": None if size is None else list(size)}


def _port_routes(path: str, data: bytes) -> dict:
    size = _or_none(native.read_image_size, path)
    return {"loader": native.decode_image(data),
            "load": _or_none(native.load_image_rgb, path),
            "img": _or_none(native.load_image_pillow, path),
            "hw": None if size is None else list(size)}


def _no_pil(monkeypatch):
    for name in ("PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)


def _check(path: str, data: bytes, monkeypatch) -> dict:
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
    got = _check(os.path.join(corpus.FOLDER, name), _read(name), monkeypatch)
    if got["img"] is not None:
        assert got["img"].dtype == np.uint8 and \
            got["img"].shape == (*got["hw"], 3)
    # the alpha the routes drop, against Pillow's RGBA
    _check_alpha(_read(name))


def test_committed_digests_equal_jax_here():
    """The digests chip_smoke.py holds the port to are the JAX routes'
    pixels on this machine, and the port's."""
    for name in NAMES:
        data = _read(name)
        assert DIGESTS[name] == corpus.reference(data), name
        img = native.decode_image(data)
        assert (None if img is None else corpus.digest(img)) == \
            DIGESTS[name]["img"], name
        size = native.webp_size(data)
        assert (None if size is None else list(size)) == DIGESTS[name]["hw"]


def test_corpus_remakes_exactly():
    made = corpus.cases()
    assert sorted(made) == NAMES
    for name, data in made.items():
        assert data == _read(name), name
    files = [n for n in os.listdir(corpus.FOLDER) if n != corpus.DIGESTS]
    assert sorted(files) == NAMES
    assert sum(len(d) for d in made.values()) < 600_000


def _chunks(name: str) -> dict:
    return dict(corpus.chunks(_read(name)))


def test_corpus_covers_what_it_claims():
    """The refusals are where they are meant to be, and the writer's files
    reach what the corpus claims: the simple filter, sharpness 1-7, levels
    0 and 63, 2-8 token partitions, segments, palettes with bundling, ALPH
    under each filter raw and coded, an animation's first frame at an
    offset, the 640x480 scenes."""
    refused = {n for n in NAMES if DIGESTS[n]["img"] is None}
    assert refused == {n for n in NAMES if n.startswith(("bad_", "cut_"))} | {
        "vp8l_one_byte_short_37x29.webp"}
    # open succeeds (so the size reads) but the pixels do not decode
    sized = {n for n in refused if DIGESTS[n]["hw"]}
    assert sized == {n for n in refused if n.startswith(
        ("bad_alph_", "bad_token_partition_", "vp8l_one_byte"))}
    for name in NAMES:
        assert DIGESTS[name]["loader"] == DIGESTS[name]["img"], name
    headers = [corpus.vp8_header(c[b"VP8 "]) for c in map(_chunks, NAMES)
               if len(c.get(b"VP8 ", b"")) > 10]
    assert {h["sharpness"] for h in headers if h["level"]} == set(range(8))
    assert {h["simple"] for h in headers if h["level"]} == {0, 1}
    assert {0, 63} <= {h["level"] for h in headers}
    assert {h["partitions"] for h in headers} == {1, 2, 4, 8}
    assert {h["segments"] for h in headers} == {0, 1}
    palettes = {corpus.vp8l_palette(c[b"VP8L"])
                for c in map(_chunks, NAMES) if b"VP8L" in c}
    assert {2, 3, 4, 5, 16, 17, 256} <= palettes
    alph = {_chunks(n)[b"ALPH"][0] for n in NAMES
            if n.startswith("alph_c") and b"ALPH" in _chunks(n)}
    assert alph == {c | f << 2 for c in (0, 1) for f in range(4)}
    first = next(p for t, p in corpus.chunks(_read(
        "anim_offset_vp8_40x30.webp")) if t == b"ANMF")
    assert first[:6] == bytes([4, 0, 0, 3, 0, 0])       # x 8, y 6
    for name in ("scene_lossy_640x480.webp", "scene_lossless_640x480.webp",
                 "scene_alpha_640x480.webp"):
        assert DIGESTS[name]["hw"] == [480, 640] and DIGESTS[name]["img"]


# each libwebp rule the decoder follows, with corpus files that fail (on
# the JAX routes' RGB, or on Pillow's RGBA where the rule is alpha's) when
# the rule is mutated in a copy of csrc/webp_decode.cc
RULES = {
    "fancy upsampler: two-step diagonal averages on packed u | v << 16":
        ["lossy_16x16.webp", "lossy_17x17.webp", "lossy_48x32.webp"],
    "fancy upsampler: the first row mirrors chroma row 0":
        ["lossy_16x16.webp", "lossy_17x17.webp", "lossy_3x5.webp"],
    "fancy upsampler: an even height's last row mirrors its chroma row":
        ["lossy_16x16.webp", "lossy_48x32.webp", "lossy_65x8.webp"],
    "fancy upsampler: an even width's last pixel":
        ["lossy_16x16.webp",
         "lossy_48x32.webp",
         "lossy_hev_level43_26x50.webp"],
    "YUV -> RGB: yuv.h's 14-bit constants":
        ["lossy_16x16.webp", "lossy_17x17.webp", "lossy_48x32.webp"],
    "YUV -> RGB: the clip at YUV_FIX2 = 6":
        ["lossy_16x16.webp", "lossy_17x17.webp", "lossy_1x1.webp"],
    "IDCT: full luma blocks through libwebp's SSE2 16-bit lanes":
        ["lossy_sse2_wrap577_29x50.webp"],
    "IDCT: chroma planes with AC through libwebp's SSE2 16-bit lanes":
        ["lossy_sse2_wrap496_29x50.webp"],
    "IDCT: MUL2 truncates":
        ["lossy_16x16.webp", "lossy_17x17.webp", "lossy_2x2.webp"],
    "IDCT: the rounder in the second pass":
        ["lossy_16x16.webp", "lossy_17x17.webp", "lossy_3x5.webp"],
    "inverse WHT: its rounder":
        ["lossy_hev_level40_29x50.webp",
         "lossy_level63_67x67.webp",
         "lossy_method1_45x39.webp"],
    "loop filter: hev is strictly above its threshold":
        ["lossy_16x16.webp", "lossy_17x17.webp", "lossy_48x32.webp"],
    "normal loop filter: the 2 * limit + 1 edge test":
        ["lossy_48x32.webp", "lossy_9x65.webp", "lossy_method0_45x39.webp"],
    "simple loop filter: the 2 * limit + 1 edge test":
        ["lossy_simple_sharp0_67x67.webp",
         "lossy_simple_sharp3_67x67.webp",
         "lossy_simple_sharp7_67x67.webp"],
    "sharpness: the interior limit shifted by 1 or 2":
        ["lossy_normal_sharp5_67x67.webp",
         "lossy_normal_sharp6_67x67.webp",
         "lossy_normal_sharp7_67x67.webp"],
    "sharpness: the interior limit capped at 9 - sharpness":
        ["lossy_normal_sharp1_67x67.webp",
         "lossy_normal_sharp2_67x67.webp",
         "lossy_normal_sharp3_67x67.webp"],
    "loop filter: hev thresholds at levels 15 and 40":
        ["lossy_hev_level43_26x50.webp"],
    "loop filter: inner edges of macroblocks with coefficients":
        ["lossy_9x65.webp",
         "lossy_hev_level40_29x50.webp",
         "lossy_hev_level43_26x50.webp"],
    "loop filter: the macroblock edge's 27/18/9 taps":
        ["lossy_level63_67x67.webp",
         "lossy_q0_33x31.webp",
         "scene_alpha_640x480.webp"],
    "4x4 prediction: the last column's top-right from the row above":
        ["lossy_top_right_48x65.webp"],
    "4x4 prediction: top-right replicated down the rightmost blocks":
        ["lossy_16x16.webp", "lossy_48x32.webp", "lossy_level0_67x67.webp"],
    "quantizer: y2 AC at least 8":
        ["lossy_y2_clamp_65x22.webp"],
    "quantizer: uv DC index clipped at 117":
        ["lossy_level63_67x67.webp",
         "lossy_q0_33x31.webp",
         "lossy_simple_level63_67x67.webp"],
    "segments: quantizer deltas on the base index":
        ["lossy_17x17.webp", "lossy_48x32.webp", "lossy_65x8.webp"],
    "token partitions by macroblock row":
        ["lossy_partitions2_67x67.webp",
         "lossy_partitions4_67x67.webp",
         "lossy_partitions8_67x67.webp"],
    "the end of a token partition fails the decode":
        ["bad_token_partition_1676_67x67.webp",
         "bad_token_partition_858_67x67.webp"],
    "VP8L predictor: the first column from above":
        ["scene_alpha_640x480.webp",
         "lossless_alpha_53x37.webp",
         "lossless_alpha_exact_53x37.webp"],
    "VP8L predictor: top-right of the last column is the row's first pixel":
        ["scene_alpha_640x480.webp",
         "lossless_gray_64x64.webp",
         "lossless_method5_45x39.webp"],
    "VP8L predictor: Select's tie":
        ["lossless_alpha_53x37.webp",
         "lossless_alpha_exact_53x37.webp",
         "lossless_gray_64x64.webp"],
    "VP8L predictor: ClampedAddSubtractHalf truncates toward zero":
        ["lossless_method4_45x39.webp",
         "lossless_method6_45x39.webp",
         "lossless_q100_61x47.webp"],
    "VP8L cross-colour: red_to_blue from the new red":
        ["lossless_alpha_53x37.webp",
         "lossless_alpha_exact_53x37.webp",
         "lossless_method4_45x39.webp"],
    "VP8L colour indexing: pixel bundling at odd widths":
        ["lossless_palette2_37x29.webp",
         "lossless_palette3_35x17.webp",
         "alph_past_end_53x36.webp"],
    "VP8L colour indexing: indices past the palette read zero":
        ["vp8l_past_palette_20x3.webp", "anim_offset_vp8l_40x30.webp"],
    "WebPAnimDecoderNew runs WebPGetFeatures first (VP8X of 10 bytes)":
        ["bad_vp8x_size12_27x21.webp"],
    "ALPH: a row's first pixel predicted from above":
        ["anim_offset_alph_40x30.webp",
         "alph_c0_filter1_53x37.webp",
         "alph_c1_filter1_53x37.webp"],
    "ALPH: the 8-bit path keeps a last symbol read past the end":
        ["alph_past_end_53x36.webp"],
    "VP8L colour cache: the 0x1e35a7bd hash":
        ["scene_lossless_640x480.webp",
         "lossless_alpha_53x37.webp",
         "lossless_palette256_53x37.webp"],
    "VP8L: a plane distance below 1 reads as 1":
        ["vp8l_plane_distance_1x5.webp"],
    "ALPH: the gradient unfilter":
        ["alph_c0_filter3_53x37.webp", "alph_c1_filter3_53x37.webp"],
    "ALPH: the vertical unfilter":
        ["alph_c0_filter2_53x37.webp", "alph_c1_filter2_53x37.webp"],
    "ALPH is decoded, and a bad one fails the decode":
        ["scene_alpha_640x480.webp",
         "anim_offset_alph_40x30.webp",
         "bad_alph_coded_cut_53x37.webp"],
    "animation: frame 1 at its offset":
        ["anim_anmf_size_mismatch_40x30.webp",
         "anim_offset_alph_40x30.webp",
         "anim_offset_vp8_40x30.webp"],
    "animation: the canvas zero-filled":
        ["anim_anmf_size_mismatch_40x30.webp",
         "anim_offset_alph_40x30.webp",
         "anim_offset_vp8_40x30.webp"],
    "demuxer: a frame inside its canvas":
        ["bad_frame_outside_x_40x30.webp"],
    "Pillow's decompression-bomb limit":
        ["bad_bomb_16384x16384.webp"],
    "the image chunk is decoded with its padding byte":
        ["vp8l_two_bytes_short_37x29.webp"],
    "VP8L: reading past the end fails the image":
        ["vp8l_one_byte_short_37x29.webp", "bad_alph_coded_cut_53x37.webp"],
    "demuxer: ALPH dropped without the VP8X alpha flag":
        ["alph_bad_no_flag_53x37.webp", "alph_no_flag_53x37.webp"],
}


def _pillow_rgba(data: bytes):
    """Pillow's convert("RGBA") where its image has alpha, else None."""
    from PIL import Image

    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGBA")) if im.mode == "RGBA" \
                else None
    except Exception:
        return None


def _decode_rgba(data: bytes):
    """The port's canvas as (h, w, 4) RGBA (the C library's
    decode_webp_rgba_u8): the alpha the routes drop, not premultiplied."""
    lib = native.decode_lib()
    hw = native.webp_size(data)
    out = np.empty((*hw, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    assert not lib.decode_webp_rgba_u8(native._as_u8p(buf), buf.size,
                                       native._as_u8p(out), *hw)
    return out


def _check_alpha(data: bytes):
    want = _pillow_rgba(data)
    if want is not None:
        np.testing.assert_array_equal(_decode_rgba(data), want)


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_cases_equal_jax(rule, monkeypatch):
    for name in RULES[rule]:
        assert name in DIGESTS, name
        _check(os.path.join(corpus.FOLDER, name), _read(name), monkeypatch)
        _check_alpha(_read(name))


@pytest.mark.parametrize("name", ["lossy_26x20_src", "lossless_18x14_src"])
def test_every_cut_equals_jax(name, tmp_path, monkeypatch):
    """Every prefix of a lossy and a lossless file: Pillow refuses each
    (the RIFF runs past the data), and so does every route of the port,
    the size included."""
    if name.startswith("lossy"):
        data = corpus.encode(corpus.picture(90, 20, 26), quality=60)
    else:
        data = corpus.pil(corpus.with_alpha(corpus.picture(91, 14, 18), 91),
                          lossless=True)
    path = str(tmp_path / "f.webp")
    for cut in range(1, len(data)):
        piece = data[:cut]
        with open(path, "wb") as f:
            f.write(piece)
        assert corpus.pillow_decode(piece) is None
        assert corpus.pillow_size(piece) is None
        with monkeypatch.context() as m:
            _no_pil(m)
            assert native.decode_image(piece) is None, cut
            assert _or_none(native.load_image_pillow, path) is None, cut
            assert _or_none(native.read_image_size, path) is None, cut


def _routed(head: bytes):
    """The plugin that Pillow's open picks by the file's first bytes."""
    picked = formats.pick(head, prefix=True)
    return picked and picked.name


def test_router_takes_pillows_webp_signatures():
    """RIFF, WEBP, and VP8 /VP8L/VP8X at 12, as Pillow's _accept; other
    RIFF WEBP files are not WebP to Pillow either; the other formats'
    signatures still select their decoders."""
    data = _read("lossy_17x17.webp")
    assert _routed(data) == "WEBP"
    for tag in (b"VP8L", b"VP8X"):
        assert _routed(data[:12] + tag + data[16:]) == "WEBP"
    for fmt, head in (("PNG", b"\x89PNG\r\n\x1a\n" + bytes(8)),
                      ("JPEG", b"\xff\xd8\xff\xe0" + bytes(12)),
                      ("BMP", b"BM" + bytes(14)),
                      ("GIF", b"GIF89a" + bytes(10))):
        assert _routed(head) == fmt
    for bad in (data[:12] + b"ALPH" + data[16:], b"RIFX" + data[4:],
                data[:8] + b"WEBQ" + data[12:], data[:15]):
        assert _routed(bad) is None
        assert corpus.pillow_decode(bad) is None
        assert native.decode_image(bad) is None


def test_canvas_under_the_bomb_limit_reads_its_size(tmp_path, monkeypatch):
    """A 10000 x 10000 animation canvas: Pillow's open reads its size
    (below the limit), and so does read_image_size, without decoding."""
    lossy = corpus.encode(corpus.picture(90, 20, 26), quality=60)
    data = corpus.animation((10000, 10000),
                            [(100, 50, 26, 20, corpus.image_chunks(lossy))])
    path = str(tmp_path / "big.webp")
    with open(path, "wb") as f:
        f.write(data)
    assert corpus.pillow_size(data) == [10000, 10000]
    with monkeypatch.context() as m:
        _no_pil(m)
        assert native.read_image_size(path) == (10000, 10000)


def test_threads_decode_alike():
    """ctypes releases the GIL; the decoder shares no state."""
    datas = [_read(n) for n in NAMES if n.startswith(("lossy_", "lossless_",
                                                      "alph_c"))]
    want = [native.decode_image(d) for d in datas]
    got = [None] * len(datas)

    def work(i):
        got[i] = native.decode_image(datas[i])

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(datas))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert all(_same(g, w) for g, w in zip(got, want))


@st.composite
def pillow_files(draw):
    """Bytes from Pillow's WebP writer."""
    h, w = draw(st.integers(1, 80)), draw(st.integers(1, 80))
    seed = draw(st.integers(0, 2 ** 16))
    arr = corpus.picture(seed, h, w)
    if draw(st.booleans()):
        arr = corpus.with_alpha(arr, seed)
    kw = {"quality": draw(st.integers(0, 100)),
          "method": draw(st.integers(0, 6)),
          "lossless": draw(st.booleans()),
          "exact": draw(st.booleans())}
    return corpus.pil(arr, **kw)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(data=pillow_files())
def test_random_pillow_files_equal_jax(data, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("f") / "f.jpg")
    with open(path, "wb") as f:
        f.write(data)
    want = _jax_routes(path, data)
    got = _port_routes(path, data)
    for route in ("loader", "load", "img"):
        assert _same(got[route], want[route]), route
    assert got["hw"] == want["hw"]


@st.composite
def writer_files(draw):
    """Bytes from the test writer over libwebp's encoder settings."""
    h, w = draw(st.integers(1, 72)), draw(st.integers(1, 72))
    seed = draw(st.integers(0, 2 ** 16))
    arr = corpus.picture(seed, h, w)
    if draw(st.booleans()):
        arr = corpus.with_alpha(arr, seed)
    kw = {k: draw(st.integers(lo, hi)) for k, lo, hi in (
        ("quality", 0, 100), ("method", 0, 6), ("filter_type", 0, 1),
        ("filter_strength", 0, 100), ("filter_sharpness", 0, 7),
        ("partitions", 0, 3), ("segments", 1, 4), ("sns_strength", 0, 100),
        ("alpha_compression", 0, 1), ("alpha_filtering", 0, 2),
        ("alpha_quality", 0, 100), ("exact", 0, 1))}
    kw["lossless"] = int(draw(st.integers(0, 4)) == 0)
    return corpus.encode(arr, **kw)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(data=writer_files())
def test_random_writer_files_equal_pillow(data):
    np.testing.assert_array_equal(native.decode_image(data),
                                  corpus.pillow_decode(data))
    assert list(native.webp_size(data)) == corpus.pillow_size(data)
