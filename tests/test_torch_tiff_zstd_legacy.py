"""Legacy zstd frames (v0.5, v0.6, v0.7) in ZSTD TIFF as the port reads them
(data/tiff.py over csrc/zstd_decode.cc) against the JAX package's routes,
which hand TIFF to Pillow 12.1.0's TiffImagePlugin over its bundled
libtiff 4.7.1 (ZSTDDecode over libzstd 1.5.7, which passes a legacy frame
to its streaming legacy decoder), on the same bytes, with PIL unimportable
for the port.

Every file of the committed corpus (tests/torch_tiff_zstd_legacy_corpus.py,
its frames written by tests/torch_zstd_legacy.py) gives, bitwise, what each
JAX route gives, or fails where it fails. Also: the committed digests equal
the JAX routes here and the generator remakes the corpus byte for byte;
every frame the corpus calls valid is decoded to its payload by libzstd
both through ZSTD_decompress and ZSTD_decompressStream; no legacy-zstd
file reaches PIL; for each rule the corpus pins, the files that fail when
the rule is mutated in a copy of the port; and two bounded sweeps: the C
decoder alone against libzstd driven as libtiff drives it (the bytes out,
the refusal, the bytes a refused chunk keeps) on changed bytes of frames
of every version, mode and block kind, and whole corpus files with
changed bytes against Pillow.
"""

import ctypes
import functools
import os
import sys
import tempfile
import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from tests import torch_tiff_corpus as tc
from tests import torch_tiff_zstd_legacy_corpus as corpus
from tests import torch_tiff_zstd_lzma_corpus as zc
from tests import torch_zstd_legacy as zl
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


@functools.cache
def _made() -> corpus.Cases:
    return corpus.cases()


def test_corpus_remakes_exactly():
    made = _made()
    assert sorted(made) == NAMES
    for name, data in made.items():
        assert data == _read(name), name
    files = [n for n in os.listdir(corpus.FOLDER) if n != corpus.DIGESTS]
    assert sorted(files) == NAMES
    total = sum(os.path.getsize(os.path.join(corpus.FOLDER, n))
                for n in os.listdir(corpus.FOLDER))
    assert total < 3_000_000
    assert set(corpus.SCENES) | {corpus.ROTATED} <= set(NAMES)


def _plain(chunk: bytes, n: int):
    """ZSTD_decompress of a frame into n bytes and a margin."""
    z = zc.libzstd()
    out = ctypes.create_string_buffer(n + 64)
    got = z.ZSTD_decompress(out, n + 64, chunk, len(chunk))
    return None if z.ZSTD_isError(got) else out.raw[:got]


def test_valid_frames_decode_both_ways_in_libzstd():
    """Every frame the corpus calls valid, the three frames of one raw
    block each (one a version) among them: libzstd's ZSTD_decompress and its streaming call
    (driven as libtiff drives it) both give the payload, and so does the
    port's C."""
    frames = _made().frames
    assert {"z5_raw_16x4.tif", "z6_raw_16x4.tif",
            "z7_raw_16x4.tif"} <= set(frames)
    assert len(frames) > 100
    for name, pairs in frames.items():
        for chunk, payload in pairs:
            assert _plain(chunk, len(payload)) == payload, name
            assert zc.zstd_libtiff(chunk, len(payload))[:2] == \
                (True, payload), name
            assert _port_chunk(chunk, len(payload), 0) == (True, payload), \
                name


def test_corpus_covers_what_it_claims():
    """Each version decoded in strips, tiles and planes, with predictor 2,
    in both byte orders and in BigTIFF, under Orientation 1-8; compressed
    blocks in the scenes; refusals of each version; the frames of one raw
    block kept."""
    decoded = [n for n in NAMES if DIGESTS[n]["img"]]
    kinds = set()
    for name in decoded:
        data = _read(name)
        d = tiff.libtiff_dir(data)
        version = data[d.offsets[0]] - 0x20
        kinds.add((version, d.tiled, d.planar, d.predictor, d.swap,
                   data[2] == 43))
    for v in (5, 6, 7):
        mine = {k for k in kinds if k[0] == v}
        assert {k[1] for k in mine} == {False, True}
        assert {k[2] for k in mine} == {1, 2}
        assert {k[3] for k in mine} == {1, 2}
        assert {k[4] for k in mine} == {False, True}
        refused = [n for n in NAMES if n.startswith(f"z{v}_") and
                   not DIGESTS[n]["img"]]
        assert len(refused) >= 8, v
        assert DIGESTS[f"z{v}_raw_16x4.tif"]["img"]
    assert any(k[5] for k in kinds)
    assert {tiff.open_tiff(_read(n)).orientation for n in decoded} >= \
        set(range(1, 9))
    for name in corpus.SCENES + (corpus.ROTATED,):
        d = tiff.libtiff_dir(_read(name))
        chunk = _read(name)[d.offsets[0]:d.offsets[0] + d.counts[0]]
        assert chunk[0] in (0x25, 0x27) and DIGESTS[name]["img"], name
        head = {0x25: 5, 0x27: 6}[chunk[0]]
        assert chunk[head] >> 6 == 0, name          # a compressed block


def test_flagship_scenes_equal_pillow():
    """The 640x480 scenes in v0.5 and v0.7 frames of compressed blocks
    decode on every route to Pillow's pixels, at Pillow's size."""
    for name in corpus.SCENES + (corpus.ROTATED,):
        assert DIGESTS[name]["hw"] == ([480, 640] if "orient" not in name
                                       else [640, 480]), name
        path = os.path.join(corpus.FOLDER, name)
        assert _port(path, _read(name)) == DIGESTS[name], name


def test_no_legacy_zstd_reaches_pil(monkeypatch):
    """Every file Pillow's plugin opens goes to the port's decoders,
    though PIL is importable; the decoders' refusals stay refusals."""
    handed = []
    monkeypatch.setattr(native, "_decode_other",
                        lambda data: handed.append(data))
    for name in NAMES:
        data = _read(name)
        native.decode_image(data)
        native.decode_image(data, by_path=True)
        header = tiff.open_tiff(data)
        assert header.compression == "zstd", name
        assert tiff.route(header, data) == "libtiff", name
    assert not handed


def test_strip_context_carries_the_buffer():
    """libzstd keeps one legacy context a stream, and libtiff one stream
    an image: a v0.7 strip whose raw block is larger than its own window's
    buffer is kept after a strip of a larger window (of the same version),
    and refused alone or after another version's."""
    assert DIGESTS["z7_context_carried_64x40.tif"]["img"]
    assert not DIGESTS["z7_small_window_big_block_64x40.tif"]["img"]
    assert not DIGESTS["z5_then_z7_small_window_64x40.tif"]["img"]


# Each rule of libzstd's legacy decoders and libtiff's loop that the
# corpus pins, and the corpus files whose routes change when the rule is
# mutated in a copy of yolov5m_tpu_torch/ (one mutation a rule).
RULES = {
    "libzstd 1.5.7: legacy support down to v0.5 (v0.4 refused)":
        ["z4_magic_19x13.tif"],
    "libzstd: a v0.5-v0.7 magic to that version's streaming decoder":
        ["scene_z5_640x480.tif", "scene_z7_640x480.tif",
        "scene_z7_orient6_640x480.tif", "z5_be_grey_37x29.tif",
        "z5_buffer_restart_64x40.tif", "z5_buffer_restart_raw_64x40.tif"],
    "libzstd: the legacy context's buffers kept from strip to strip":
        ["z7_context_carried_64x40.tif"],
    "zstd_v05, v0.6: a four-stream section of one byte repeats it":
        ["z5_huf4_one_byte_20x3.tif", "z6_huf4_one_byte_20x3.tif"],
    "zstd_v05-v07: RLE blocks refused by the streaming decoders":
        ["z5_rle_block_19x13.tif", "z6_rle_block_19x13.tif",
        "z7_rle_block_19x13.tif"],
    "zstd_v05-v07: a block of size 0 ends the streaming decoder's frame":
        ["z5_empty_block_first_19x13.tif", "z5_empty_block_mid_19x13.tif",
        "z6_empty_block_first_19x13.tif", "z6_empty_block_mid_19x13.tif",
        "z7_empty_block_first_19x13.tif", "z7_empty_block_mid_19x13.tif"],
    "zstd_v05-v07: one block decoded past a full output":
        ["z5_bad_block_after_full_19x13.tif",
        "z6_bad_block_after_full_19x13.tif",
        "z7_bad_block_after_full_19x13.tif", "z7_bad_checksum_19x13.tif"],
    "zstd_v05: a buffer of the window alone, restarted at its start":
        ["z5_raw_block_past_window_48x64.tif"],
    "zstd_v05: long match lengths through the dumps":
        ["scene_z5_640x480.tif", "z5_long_lengths_1000x110.tif",
        "z5_tiles_37x29.tif"],
    "zstd_v05: one repeat offset, the last one or the one before":
        ["scene_z5_640x480.tif"],
    "zstd_v05: raw sequence tables read each code in its own bits":
        ["z5_long_lengths_1000x110.tif", "z5_tiles_37x29.tif"],
    "zstd_v05: the Huffman weights' FSE stream ends with both states at 0":
        ["scene_z5_640x480.tif"],
    "zstd_v05: the descriptor's upper nibble reserved":
        ["z5_reserved_bit4_19x13.tif"],
    "zstd_v06, v0.7: v1's predefined literal-length distribution":
        ["z6_repeats_reset_per_block_72x1.tif",
        "z7_repeats_across_blocks_72x1.tif"],
    "zstd_v06: a four-stream section as long as its literals copied":
        ["z6_huf4_uncompressed_20x3.tif"],
    "zstd_v06: descriptor bit 5 reserved":
        ["z6_reserved_bit5_19x13.tif"],
    "zstd_v06: repeat offsets start at 1, 1, 1 in every block":
        ["z6_repeats_reset_per_block_72x1.tif"],
    "zstd_v07: a dictionary ID refused without a dictionary":
        ["z7_dict_id_19x13.tif"],
    "zstd_v07: descriptor bit 3 reserved":
        ["z7_reserved_bit3_19x13.tif"],
    "zstd_v07: repeat offsets carried from block to block":
        ["z7_repeats_across_blocks_72x1.tif"],
    "zstd_v07: repeated Huffman literals need a two-symbol table":
        ["z7_lits_repeat_x2_100x20.tif"],
    "zstd_v07: the checksum's 22 bits in the end block":
        ["z7_bad_checksum_19x13.tif"],
    "zstd_v07: the last block's sequence tables repeated":
        ["z7_tables_repeat_1347x1.tif"],
    "zstd_v07: window log at most 27":
        ["z7_window_log28_19x13.tif"],
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_cases_equal_jax(rule):
    assert RULES[rule]
    for name in RULES[rule]:
        path = os.path.join(corpus.FOLDER, name)
        assert _port(path, _read(name)) == DIGESTS[name], name


# -- the C decoder alone against libzstd ---------------------------------------

@functools.cache
def _lib():
    lib = native.decode_lib()
    lib.zstd_tiff_chunk.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.c_char_p, ctypes.c_int64]
    lib.zstd_tiff_chunk.restype = ctypes.c_int
    return lib


def _port_chunk(chunk: bytes, occ: int, fill: int):
    dst = ctypes.create_string_buffer(bytes([fill]) * occ, max(occ, 1))
    kept = _lib().zstd_tiff_chunk(chunk, len(chunk), dst, occ)
    return bool(kept), dst.raw[:occ]


def _content(draw) -> bytes:
    """Smooth, noisy, repeating, flat or skewed bytes."""
    n = draw(st.sampled_from((1, 9, 300, 741, 3000, 20000, 140000)))
    seed = draw(st.integers(0, 2 ** 16))
    kind = draw(st.sampled_from(("smooth", "noise", "repeat", "flat",
                                 "skewed")))
    rng = np.random.default_rng(seed)
    if kind == "smooth":
        return (np.cumsum(rng.integers(-2, 3, n)) % 256).astype(
            np.uint8).tobytes()
    if kind == "noise":
        return rng.integers(0, 256, n, np.uint8).tobytes()
    if kind == "repeat":
        unit = rng.integers(0, 256, int(rng.integers(1, 40)), np.uint8)
        return np.resize(unit, n).tobytes()
    if kind == "skewed":
        return rng.choice(np.arange(10), n, p=corpus.P10).astype(
            np.uint8).tobytes()
    return bytes([seed & 255]) * n


def _changed(draw, data: bytes) -> bytes:
    """data cut, extended, or with one to eight bytes changed."""
    how = draw(st.sampled_from(("keep", "flip", "flip", "bytes", "cut",
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


@st.composite
def legacy_chunks(draw):
    v = draw(st.sampled_from((5, 6, 7)))
    data = _content(draw)
    kw = {"window_log": draw(st.sampled_from((18, 19, 20) if v == 5 else
                                             (10, 17, 20))),
          "block_size": draw(st.sampled_from((zl.BLOCK - 1024, 5000, 700))),
          "kinds": draw(st.sampled_from((("lz",), ("raw",), ("lz", "raw")))),
          "lits": draw(st.sampled_from(("auto", "raw", "huf1", "huf4")))}
    modes = draw(st.sampled_from(("auto", "fse", "predef")))
    if modes != "auto":
        kw["modes"] = (("raw" if v == 5 and modes == "predef" else modes),) * 3
    if v == 7:
        kw["checksum"] = draw(st.booleans())
    try:
        frame = zl.frame(v, data, **kw)
    except ValueError:
        kw["lits"] = "auto"
        frame = zl.frame(v, data, **kw)
    occ = max(1, len(data) + draw(st.sampled_from((0, 0, 0, -1, 1,
                                                   -len(data) // 2, 37))))
    return _changed(draw, frame), occ, draw(st.integers(0, 255))


@settings(max_examples=150, deadline=None, derandomize=True)
@given(case=legacy_chunks())
def test_legacy_decoder_equals_libzstd(case):
    """The port's chunk decoder against libzstd as libtiff drives it: the
    kept flag and every byte of the output, a refused chunk's included
    (an error of a legacy decoder leaves the output as it was, past what
    was flushed)."""
    chunk, occ, fill = case
    kept, got, _ = zc.zstd_libtiff(chunk, occ, fill)
    assert _port_chunk(chunk, occ, fill) == (kept, got)


@st.composite
def changed_files(draw):
    name = draw(st.sampled_from([n for n in NAMES
                                 if not n.startswith("scene")]))
    data = _read(name)
    d = tiff.libtiff_dir(data)
    k = draw(st.integers(0, len(d.offsets) - 1))
    off, cnt = d.offsets[k], d.counts[k]
    chunk = _changed(draw, data[off:off + cnt])
    if len(chunk) != cnt:
        chunk = (chunk + bytes(cnt))[:cnt]
    return name, data[:off] + chunk + data[off + cnt:]


@settings(max_examples=40, deadline=None, derandomize=True)
@given(case=changed_files())
def test_changed_bytes_equal_pillow(case):
    """Corpus files with bytes of one chunk changed: every route equals
    Pillow's."""
    name, data = case
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, name)
        with open(path, "wb") as f:
            f.write(data)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = tc.reference(path)
        assert _port(path, data) == want
