"""ZSTD and LZMA TIFF as the port reads them (data/tiff.py over
csrc/zstd_decode.cc and csrc/xz_decode.cc) against the JAX package's
routes, which hand TIFF to Pillow 12.1.0's TiffImagePlugin over its bundled
libtiff 4.7.1 (ZSTDDecode over libzstd 1.5.7, LZMADecode over liblzma
5.8.2), on the same bytes, with PIL unimportable for the port.

Every file of the committed corpus (tests/torch_tiff_zstd_lzma_corpus.py)
gives, bitwise, what each JAX route gives, or fails where it fails: the
server's ``_decode_image`` on the bytes, the loader's ``load_image_rgb``
and detect ``--img``'s ``Image.open(path).convert("RGB")`` on the path,
and the dataset's ``_read_image_size``. Also: the committed digests equal
the JAX routes here and the generator remakes the corpus byte for byte;
each finding of the probe of libtiff's loops holds; no ZSTD, LZMA or WebP
TIFF reaches PIL; for each rule the corpus pins, the files that fail when
the rule is mutated in a copy of the port; and a bounded sweep that holds
each C decoder alone against its library driven as libtiff drives it (the
bytes out, the refusal, the bytes a refused chunk keeps), on valid frames
and streams and on changed bytes.
"""

import ctypes
import functools
import os
import sys
import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from tests import torch_tiff_corpus as tc
from tests import torch_tiff_zstd_lzma_corpus as corpus
from yolov5m_tpu_torch.data import native, tiff

torch.set_num_threads(1)

DIGESTS = corpus.load()
NAMES = sorted(DIGESTS)


def _read(name: str) -> bytes:
    with open(os.path.join(corpus.FOLDER, name), "rb") as f:
        return f.read()


def _attempt(call, *args):
    try:
        return call(*args)
    except ValueError:
        return None


def _port(path: str, data: bytes) -> dict:
    """Each of the port's routes with PIL unimportable."""
    saved = {k: sys.modules.get(k) for k in ("PIL", "PIL.Image")}
    sys.modules.update({"PIL": None, "PIL.Image": None})
    try:
        hw = _attempt(native.read_image_size, path)
        return {"loader": corpus.digest(native.decode_image(data)),
                "load": corpus.digest(_attempt(native.load_image_rgb, path)),
                "img": corpus.digest(_attempt(native.load_image_pillow,
                                              path)),
                "hw": None if hw is None else list(hw)}
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


@pytest.mark.parametrize("name", NAMES)
def test_corpus_file_equals_jax(name):
    path = os.path.join(corpus.FOLDER, name)
    assert _port(path, _read(name)) == DIGESTS[name]


def test_committed_digests_equal_jax_here():
    """The digests chip_smoke.py holds the port to are the JAX routes'
    pixels and sizes on this machine."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name in NAMES:
            path = os.path.join(corpus.FOLDER, name)
            assert DIGESTS[name] == tc.reference(path), name


def test_corpus_remakes_exactly():
    made = corpus.cases()
    assert sorted(made) == NAMES
    for name, data in made.items():
        assert data == _read(name), name
    files = [n for n in os.listdir(corpus.FOLDER) if n != corpus.DIGESTS]
    assert sorted(files) == NAMES
    total = sum(os.path.getsize(os.path.join(corpus.FOLDER, n))
                for n in os.listdir(corpus.FOLDER))
    assert total < 2_000_000
    assert set(corpus.SCENES) | {corpus.ROTATED} <= set(NAMES)


def test_corpus_covers_what_it_claims():
    """Both codecs decoded in strips, tiles and planes, under predictors
    1-3, in both byte orders, in BigTIFF, at fill order 2, as YCbCr
    (TIFFRGBAImage) and under Orientation 1-8; refusals of both; WebP
    refused with its size read."""
    decoded = [n for n in NAMES if DIGESTS[n]["img"]]
    kinds = set()
    for name in decoded:
        data = _read(name)
        d = tiff.libtiff_dir(data)
        kinds.add((d.compression, d.predictor, d.tiled, d.planar, d.swap,
                   d.fillorder, d.photometric, data[2] == 43))
    for codec in (50000, 34925):
        mine = {k for k in kinds if k[0] == codec}
        assert {k[1] for k in mine} == {1, 2, 3}
        assert {k[2] for k in mine} == {False, True}
        assert {k[3] for k in mine} == {1, 2}
        assert {k[4] for k in mine} == {False, True}
        assert {k[5] for k in mine} == {1, 2}
        assert 6 in {k[6] for k in mine}
        assert True in {k[7] for k in mine}
    assert {tiff.open_tiff(_read(n)).orientation for n in decoded} >= \
        set(range(1, 9))
    refused = [n for n in NAMES if DIGESTS[n]["hw"] and
               not DIGESTS[n]["img"]]
    assert len({n[:2] for n in refused}) >= 2 and len(refused) > 20
    for name in ("webp_rgb_19x13.tif", "webp_ycbcr22_38x26.tif"):
        assert DIGESTS[name]["hw"] and not DIGESTS[name]["img"], name


@pytest.mark.parametrize("name", sorted(corpus.FINDINGS))
def test_probe_finding_holds(name):
    """Each finding of the probe is a corpus file: Pillow keeps the image
    or refuses it as the probe found, and the port with it."""
    assert (DIGESTS[name]["img"] is not None) == corpus.FINDINGS[name]
    path = os.path.join(corpus.FOLDER, name)
    assert _port(path, _read(name)) == DIGESTS[name]


def _strip(name: str):
    """(chunk, decoded size) of a one-strip corpus file."""
    data = _read(name)
    d = tiff.libtiff_dir(data)
    return data[d.offsets[0]:d.offsets[0] + d.counts[0]], tiff._occ(d, 0,
                                                                     False)


def test_probe_details_hold():
    """The libraries as libtiff drives them: the frame cut by its last
    four bytes comes out four bytes short (libzstd streamed the rest); the
    flipped level-19 frame is kept with a few bytes changed; the flipped
    xz stream's fault comes after the output is full; an .lzma strip and
    a skippable frame are refused at once."""
    chunk, occ = _strip("z_cut_last4_19x13.tif")
    kept, got, why = corpus.zstd_libtiff(chunk, occ)
    assert not kept and why == "short 4 bytes"
    assert got[:-4] == corpus.noise(9, 13, 19).tobytes()[:-4]
    clean = corpus.skewed(8, 29, 37).tobytes()
    chunk, occ = _strip("z_flipped_kept_l19_a_37x29.tif")
    kept, got, _ = corpus.zstd_libtiff(chunk, occ)
    assert kept and 0 < sum(a != b for a, b in zip(got, clean)) <= 3
    chunk, occ = _strip("x_flipped_kept_19x13.tif")
    kept, got, ret = corpus.lzma_libtiff(chunk, occ)
    assert kept and ret not in (0, 1)
    chunk, occ = _strip("x_lzma_alone_19x13.tif")
    assert corpus.lzma_libtiff(chunk, occ)[2] == 7        # FORMAT_ERROR
    chunk, occ = _strip("z_skippable_first_19x13.tif")
    assert corpus.zstd_libtiff(chunk, occ)[2] == "short 741 bytes"


def test_no_zstd_lzma_or_webp_reaches_pil(monkeypatch):
    """Every file Pillow's plugin opens goes to the port's decoders, though
    PIL is importable: ZSTD, LZMA and WebP are no longer left by their
    tags, and the decoders' refusals stay refusals."""
    handed = []
    monkeypatch.setattr(native, "_decode_other",
                        lambda data: handed.append(data))
    for name in NAMES:
        data = _read(name)
        native.decode_image(data)
        native.decode_image(data, by_path=True)
        header = tiff.open_tiff(data)
        assert header.compression in ("zstd", "lzma", "webp"), name
        assert tiff.route(header, data) == "libtiff", name
    assert not handed


def test_port_reads_no_lzma_or_zstd_module():
    """The port's decoders are its own C: no module of it imports Python's
    lzma (whose liblzma may differ, or be missing, on the card's machine),
    nor a zstd binding."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))
    for folder, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(folder, name)) as f:
                    text = f.read()
                for module in ("lzma", "zstd", "zstandard"):
                    assert f"import {module}" not in text, name
                    assert f"from {module} " not in text, name


# Each rule of libtiff's, libzstd's and liblzma's that the corpus pins, and
# the corpus files whose routes change when the rule is mutated in a copy
# of yolov5m_tpu_torch/ (one mutation a rule).
RULES = {
    "RFC 8878: a frame's content size checked at its last block":
        ["z_content_size_past_strip_19x13.tif"],
    "RFC 8878: repeat offsets start at 1, 4, 8":
        ["lw_zstd_cmyk_planar_37x29.tif", "lw_zstd_float32_pred3_37x29.tif",
        "lw_zstd_float32_pred3_be_37x29.tif",
        "lw_zstd_grey16_pred2_37x29.tif", "lw_zstd_palette8_37x29.tif",
        "lw_zstd_rgb_planar_37x29.tif"],
    "RFC 8878: the predefined literal-length distribution":
        ["lw_zstd_cmyk_planar_37x29.tif", "lw_zstd_float32_pred3_37x29.tif",
        "lw_zstd_float32_pred3_be_37x29.tif",
        "lw_zstd_grey16_pred2_37x29.tif", "lw_zstd_grey4_37x29.tif",
        "lw_zstd_level1_37x29.tif"],
    "liblzma: ARM BCJ":
        ["x_arm_code_19x13.tif"],
    "liblzma: ARM-Thumb BCJ":
        ["x_armthumb_code_19x13.tif"],
    "liblzma: ARM64 BCJ's ADRP range":
        ["x_arm64_19x13.tif", "x_small_dict_arm64_64x40.tif"],
    "liblzma: IA-64 BCJ":
        ["x_ia64_code_19x13.tif"],
    "liblzma: LZMA2's lc + lp at most 4":
        ["x_lc1_lp3_pb1_19x13.tif", "x_lc4_lp0_pb0_19x13.tif"],
    "liblzma: PowerPC BCJ":
        ["x_powerpc_19x13.tif", "x_powerpc_code_19x13.tif"],
    "liblzma: RISC-V BCJ":
        ["x_riscv_code_19x13.tif"],
    "liblzma: SPARC BCJ":
        ["x_sparc_code_19x13.tif"],
    "liblzma: a check ID it does not know skipped (flags 0)":
        ["x_check_id15_19x13.tif", "x_check_id2_19x13.tif"],
    "liblzma: the block's check verified":
        ["x_two_blocks_bad_first_crc32_19x13.tif"],
    "liblzma: the delta filter's distance":
        ["lw_lzma_cmyk_planar_37x29.tif", "lw_lzma_float32_pred3_37x29.tif",
        "lw_lzma_float32_pred3_be_37x29.tif",
        "lw_lzma_grey16_pred2_37x29.tif",
        "lw_lzma_grey16_pred2_be_37x29.tif",
        "lw_lzma_grey32_pred2_37x29.tif"],
    "liblzma: the range coder ends each LZMA2 chunk at zero":
        ["x_two_blocks_first_rc_unfinished_19x13.tif"],
    "liblzma: the simple coder holds back its unfiltered tail":
        ["x_ycbcr22_cut_x86_38x26.tif"],
    "liblzma: x86 BCJ's targets relative to the next instruction":
        ["x_uncompressed_chunks_x86_19x13.tif", "x_x86_code_19x13.tif"],
    "libtiff: LZMADecode keeps a chunk whose output is full, whatever follows":
        ["x_bad_crc32_19x13.tif", "x_flipped_kept_19x13.tif"],
    "libtiff: LZMADecode zeroes a refused chunk past lzma_code's position":
        ["x_ycbcr22_cut_x86_38x26.tif"],
    "libtiff: ZSTDDecode zeroes a refused chunk past the stream's position":
        ["z_ycbcr22_bad_checksum_38x26.tif"],
    "libtiff: fill order 2 reverses a ZSTD or LZMA chunk":
        ["lw_lzma_rgb_fillorder2_37x29.tif",
        "lw_zstd_rgb_fillorder2_37x29.tif"],
    "libtiff: the Predictor tag read under ZSTD and LZMA":
        ["lw_lzma_float32_pred3_37x29.tif",
        "lw_lzma_float32_pred3_be_37x29.tif",
        "lw_lzma_grey16_pred2_37x29.tif",
        "lw_lzma_grey16_pred2_be_37x29.tif",
        "lw_lzma_grey32_pred2_37x29.tif", "lw_lzma_rgb_pred2_37x29.tif"],
    "libzstd: a dictionary ID refused without a dictionary":
        ["z_dict_id_19x13.tif", "z_dict_id_no_content_size_19x13.tif"],
    "libzstd: a frame decoded in one pass where its "
    "content size fits the output (no window limit there)":
        ["z_window_log28_content_size_19x13.tif"],
    "libzstd: a skippable frame ends libtiff's loop":
        ["z_skippable_first_19x13.tif",
        "z_skippable_nibble15_first_19x13.tif"],
    "libzstd: four Huffman streams through the "
    "x86-64 loop, no stream's end checked":
        ["z_flipped_literal_stream_37x29.tif"],
    "libzstd: raw blocks streamed as their bytes arrive":
        ["z_ycbcr22_cut_last4_38x26.tif"],
    "libzstd: the buffered stream's window limit, 2^27 + 1":
        ["z_window_log27_and_more_19x13.tif", "z_window_log28_19x13.tif",
        "z_window_log31_19x13.tif"],
    "libzstd: the content checksum checked":
        ["z_bad_checksum_19x13.tif",
        "z_bad_checksum_no_content_size_19x13.tif",
        "z_ycbcr22_bad_checksum_38x26.tif"],
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_cases_equal_jax(rule):
    assert RULES[rule]
    for name in RULES[rule]:
        path = os.path.join(corpus.FOLDER, name)
        assert _port(path, _read(name)) == DIGESTS[name], name


# -- the C decoders alone against their libraries -----------------------------

@functools.cache
def _lib():
    lib = native.decode_lib()
    for name in ("zstd_tiff_chunk", "xz_tiff_chunk"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
                       ctypes.c_int64]
        fn.restype = ctypes.c_int
    return lib


def _port_chunk(name: str, chunk: bytes, occ: int, fill: int):
    dst = ctypes.create_string_buffer(bytes([fill]) * occ, max(occ, 1))
    kept = getattr(_lib(), name)(chunk, len(chunk), dst, occ)
    return bool(kept), dst.raw[:occ]


def _content(draw) -> bytes:
    """Smooth, noisy, repeating or flat bytes."""
    n = draw(st.sampled_from((1, 9, 300, 741, 3000, 20000, 140000)))
    seed = draw(st.integers(0, 2 ** 16))
    kind = draw(st.sampled_from(("smooth", "noise", "repeat", "flat")))
    rng = np.random.default_rng(seed)
    if kind == "smooth":
        return (np.cumsum(rng.integers(-2, 3, n)) % 256).astype(
            np.uint8).tobytes()
    if kind == "noise":
        return rng.integers(0, 256, n, np.uint8).tobytes()
    if kind == "repeat":
        unit = rng.integers(0, 256, int(rng.integers(1, 40)), np.uint8)
        return np.resize(unit, n).tobytes()
    return bytes([seed & 255]) * n


def _changed(draw, data: bytes) -> bytes:
    """data cut, extended, or with one to eight bytes changed."""
    how = draw(st.sampled_from(("keep", "keep", "flip", "bytes", "cut",
                                "extend")))
    if not data or how == "keep":
        return data
    if how == "cut":
        return data[:draw(st.integers(0, len(data) - 1))]
    if how == "extend":
        return data + bytes(draw(st.lists(st.integers(0, 255), min_size=1,
                                          max_size=16)))
    out = bytearray(data)
    for _ in range(1 if how == "flip" else draw(st.integers(1, 8))):
        at = draw(st.integers(0, len(out) - 1))
        out[at] = out[at] ^ (1 << draw(st.integers(0, 7))) if how == "flip" \
            else draw(st.integers(0, 255))
    return bytes(out)


def _occ(draw, n: int) -> int:
    return max(1, n + draw(st.sampled_from((0, 0, 0, -1, 1, -n // 2, 37))))


@st.composite
def zstd_chunks(draw):
    data = _content(draw)
    params = {"level": draw(st.sampled_from((-5, -1, 1, 3, 9, 19, 22)))}
    if draw(st.booleans()):
        params["checksum"] = 1
    if draw(st.booleans()):
        params["content_size"] = 0
    if draw(st.integers(0, 4)) == 0:
        params["window_log"] = draw(st.sampled_from((10, 17, 20)))
    frame = corpus.zstd_frame(data, streaming=draw(st.booleans()), **params)
    return _changed(draw, frame), _occ(draw, len(data)), \
        draw(st.integers(0, 255))


@settings(max_examples=80, deadline=None, derandomize=True)
@given(case=zstd_chunks())
def test_zstd_decoder_equals_libzstd(case):
    chunk, occ, fill = case
    kept, got, _ = corpus.zstd_libtiff(chunk, occ, fill)
    assert _port_chunk("zstd_tiff_chunk", chunk, occ, fill) == (kept, got)


@st.composite
def xz_chunks(draw):
    data = _content(draw)
    kw = {"preset": draw(st.integers(0, 9)), "extreme": draw(st.booleans()),
          "check": draw(st.sampled_from(sorted(corpus.CHECKS)))}
    chain = draw(st.lists(st.sampled_from(sorted(corpus.FILTERS)),
                          max_size=2, unique=True))
    kw["filters"] = tuple((f, draw(st.integers(1, 256)) if f == "delta"
                           else 0) for f in chain)
    if draw(st.integers(0, 4)) == 0:
        kw["dict_size"] = 4096
    stream = corpus.xz_stream(data, **kw)
    return _changed(draw, stream), _occ(draw, len(data)), \
        draw(st.integers(0, 255))


@settings(max_examples=80, deadline=None, derandomize=True)
@given(case=xz_chunks())
def test_xz_decoder_equals_liblzma(case):
    chunk, occ, fill = case
    kept, got, _ = corpus.lzma_libtiff(chunk, occ, fill)
    assert _port_chunk("xz_tiff_chunk", chunk, occ, fill) == (kept, got)


@pytest.mark.parametrize("name", ("x86", "arm64", "riscv"))
def test_bcj_code_strips_equal_liblzma(name):
    """The filters liblzma 5.8 also exports alone: its encoder changes the
    corpus' code-like strip, and the port's chain undoes it."""
    k = ("x86", "powerpc", "ia64", "arm", "armthumb", "sparc", "arm64",
         "riscv").index(name)
    data = corpus.code_like(name, 20 + k, 741)
    encode = getattr(corpus.liblzma(), f"lzma_bcj_{name}_encode")
    encode.restype = ctypes.c_size_t
    encode.argtypes = [ctypes.c_uint32, ctypes.c_char_p, ctypes.c_size_t]
    buf = ctypes.create_string_buffer(data, len(data))
    encode(0, buf, len(data))
    assert buf.raw != data
    stream = corpus.xz_stream(data, filters=((name, 0),))
    assert _port_chunk("xz_tiff_chunk", stream, len(data), 0) == \
        (True, data)
