"""YCbCr and JPEG-compressed TIFF as the port reads them (data/tiff.py,
csrc/jpeg_decode.cc's mode 2, the putters in csrc/tiff_decode.cc) against
the JAX package's routes, which hand TIFF to Pillow 12.1.0's
TiffImagePlugin over its bundled libtiff 4.7.1 (the JPEG codec over
libjpeg-turbo 3.1.3, TIFFRGBAImage for YCbCr), on the same bytes, with PIL
unimportable for the port.

Every file of the committed corpus (tests/torch_tiff_jpeg_corpus.py) gives,
bitwise, what each JAX route gives, or fails where it fails: the server's
``_decode_image`` on the bytes, the loader's ``load_image_rgb`` and detect
``--img``'s ``Image.open(path).convert("RGB")`` on the path, and the
dataset's ``_read_image_size``. Also: the committed digests equal the JAX
routes here and the generator remakes the corpus byte for byte; the
640x480 scenes chip_smoke.py makes on the card; no YCbCr or JPEG file
reaches PIL; libtiff's YCbCr tables against its own TIFFYCbCrToRGBInit;
for each rule the corpus pins, the files that fail when the rule is
mutated in a copy of the port; a bounded sweep of encoder settings and of
bytes changed in the corpus' files.
"""

import ctypes
import functools
import io
import logging
import os
import struct
import sys
import warnings

import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings, strategies as st

from tests import torch_jpeg_fixtures
from tests import torch_tiff_corpus as tc
from tests import torch_tiff_jpeg_corpus as corpus
from yolov5m_tpu_torch.data import native, tiff

torch.set_num_threads(1)
logging.getLogger("PIL").setLevel(logging.CRITICAL)

DIGESTS = corpus.load()
NAMES = sorted(DIGESTS)
SCENE_DIGESTS = corpus.load(name=corpus.SCENE_DIGESTS)


@functools.cache
def _scenes() -> dict:
    return corpus.scene_cases(torch_jpeg_fixtures.scene(0))


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


def _jax(path: str) -> dict:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return tc.reference(path)


def _write(tmp_path, data: bytes, name: str = "f.tif") -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


@pytest.mark.parametrize("name", NAMES)
def test_corpus_file_equals_jax(name):
    path = os.path.join(corpus.FOLDER, name)
    assert _port(path, _read(name)) == DIGESTS[name]


def test_committed_digests_equal_jax_here():
    """The digests chip_smoke.py holds the port to are the JAX routes'
    pixels and sizes on this machine."""
    for name in NAMES:
        assert DIGESTS[name] == _jax(os.path.join(corpus.FOLDER, name)), name


def test_corpus_remakes_exactly():
    made = corpus.cases()
    assert sorted(made) == NAMES
    for name, data in made.items():
        assert data == _read(name), name
    files = [n for n in os.listdir(corpus.FOLDER)
             if n not in (corpus.DIGESTS, corpus.SCENE_DIGESTS)]
    assert sorted(files) == NAMES
    assert sum(len(d) for d in made.values()) < 2_000_000


def test_corpus_covers_what_it_claims():
    """JPEG under every photometric of 8-bit samples and YCbCr under every
    codec, decoded; both YCbCr routes at every subsampling; refusals."""
    decoded = {n for n in NAMES if DIGESTS[n]["img"]}
    kinds = set()
    for name in decoded:
        ldir = tiff.libtiff_dir(_read(name)) if not name.startswith(
            ("yc_raw", "yc_grey_raw", "pw_ycbcr_raw")) else None
        if ldir is not None:
            kinds.add((ldir.compression, ldir.photometric, ldir.planar,
                       ldir.subsampling if ldir.photometric == 6 else None,
                       ldir.tiled))
    assert {(c, p) for c, p, *_ in kinds} >= {
        (7, 0), (7, 1), (7, 2), (7, 5), (7, 6), (5, 6), (8, 6), (32773, 6)}
    subsampled = {s for c, p, pl, s, _ in kinds if p == 6 and pl == 1}
    assert subsampled >= {(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2),
                          (4, 4)}
    assert {(c == 7, pl, t) for c, p, pl, s, t in kinds if p == 6} >= {
        (True, 1, False), (True, 1, True), (True, 2, False),
        (True, 2, True), (False, 1, False), (False, 1, True),
        (False, 2, False)}
    refused = [n for n in NAMES if DIGESTS[n]["hw"] and
               not DIGESTS[n]["img"]]
    assert len(refused) > 30
    # uncompressed YCbCr: Pillow's raw route reads four bytes a pixel
    assert not DIGESTS["pw_ycbcr_raw_19x13.tif"]["img"]
    assert DIGESTS["yc_raw_4bytes_19x13.tif"]["img"]


def test_raw_ycbcr_is_truncated_as_pillow_says(tmp_path):
    """Pillow's raw route unpacks uncompressed YCbCr as RGBX (four bytes a
    pixel from three): its own 19x13 file runs out, "image file is
    truncated"; the port refuses it with the same words."""
    from PIL import Image

    data = _read("pw_ycbcr_raw_19x13.tif")
    with pytest.raises(OSError, match="image file is truncated"):
        with Image.open(io.BytesIO(data)) as im:
            im.load()
    with pytest.raises(ValueError, match="image file is truncated"):
        tiff.decode(data)


@pytest.mark.parametrize("name", sorted(SCENE_DIGESTS))
def test_scene_equals_committed_digests(name, tmp_path):
    """The 640x480 scenes chip_smoke.py remakes on the card: the digests it
    holds them to are Pillow's, and the port's."""
    data = _scenes()[name]
    path = _write(tmp_path, data, name)
    assert _jax(path) == SCENE_DIGESTS[name]
    assert _port(path, data) == SCENE_DIGESTS[name]


def test_no_ycbcr_or_jpeg_reaches_pil(monkeypatch):
    """Every file the plugin opens goes to the port's decoders, though PIL
    is importable: YCbCr and JPEG are no longer left by their tags."""
    handed = []
    monkeypatch.setattr(native, "_decode_other",
                        lambda data: handed.append(data))
    for name in NAMES:
        data = _read(name)
        before = len(handed)
        native.decode_image(data)
        try:
            header = tiff.open_tiff(data)
        except tiff.NotTiff:            # Pillow's other plugins: PIL
            continue
        except ValueError:
            assert len(handed) == before, name
            continue
        assert tiff.route(header, data) is not None, name
        assert len(handed) == before, name


def _libtiff_tables(luma, refbw):
    """libtiff's own TIFFYCbCrToRGBInit (Pillow's bundled library): the
    five tables it fills, or None where it is not run."""
    from PIL import Image  # noqa: F401  (loads libtiff's dependencies)

    lib = ctypes.CDLL(tc.pillow_libtiff())
    state = (ctypes.c_uint8 * 16384)()
    fp = ctypes.POINTER(ctypes.c_float)
    lib.TIFFYCbCrToRGBInit.argtypes = [ctypes.c_void_p, fp, fp]
    luma = np.array(luma, np.float32)
    refbw = np.array(refbw, np.float32)
    lib.TIFFYCbCrToRGBInit(state, luma.ctypes.data_as(fp),
                           refbw.ctypes.data_as(fp))
    ptrs = struct.unpack_from("6P", bytes(state))
    base = ctypes.addressof(state)
    return np.concatenate([np.frombuffer(
        bytes(state)[p - base:p - base + 1024], np.int32)
        for p in ptrs[1:]])


@pytest.mark.parametrize("luma,refbw", [
    ((0.299, 0.587, 0.114), (0, 255, 128, 255, 128, 255)),
    ((0.2125, 0.7154, 0.0721), (16, 235, 128, 240, 128, 240)),
    ((0.5, 0.0001, 0.5), (10.5, 200.25, 30, 220, 60, 250)),
    ((1.5, 0.25, -0.5), (-300, 900, 128, 128, -1e6, 1e6)),
    ((0.299, 0.587, 0.114), (0, 0, 0, 0, 0, 0))])
def test_ycbcr_tables_equal_libtiff(luma, refbw):
    mine = np.zeros(1280, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    lu = np.array(luma, np.float32)
    rb = np.array(refbw, np.float32)
    assert native.decode_lib().tiff_ycbcr_tables(
        lu.ctypes.data_as(fp), rb.ctypes.data_as(fp),
        mine.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))) == 0
    np.testing.assert_array_equal(mine, _libtiff_tables(luma, refbw))


def test_sizes_equal_libtiff():
    """TIFFScanlineSize and TIFFStripSize/TileSize of packed YCbCr and of
    JPEGCOLORMODE_RGB's upsampled rows, as libtiff computes them."""
    from PIL import Image  # noqa: F401

    lib = ctypes.CDLL(tc.pillow_libtiff())
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    for f in ("TIFFScanlineSize64", "TIFFStripSize64", "TIFFTileSize64"):
        getattr(lib, f).restype = ctypes.c_uint64
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    lib.TIFFSetField.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                 ctypes.c_int]
    lib.TIFFClose.argtypes = [ctypes.c_void_p]
    handler = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_void_p)(lambda *a: None)
    for f in (lib.TIFFSetErrorHandler, lib.TIFFSetWarningHandler):
        f.argtypes, f.restype = [ctypes.c_void_p], ctypes.c_void_p
    quiet = ctypes.cast(handler, ctypes.c_void_p)
    # libtiff's handlers are global: Pillow's own are put back after
    saved = (lib.TIFFSetErrorHandler(quiet), lib.TIFFSetWarningHandler(quiet))
    try:
        _check_sizes(lib)
    finally:
        lib.TIFFSetErrorHandler(saved[0])
        lib.TIFFSetWarningHandler(saved[1])


def _check_sizes(lib):
    checked = 0
    for name in NAMES:
        if not name.startswith(("yc_lzw", "lw_ycbcr", "hm_ycbcr")):
            continue
        try:
            ldir = tiff.libtiff_dir(_read(name))
        except ValueError:
            continue
        for upsampled in (False, True) if ldir.compression == 7 else (False,):
            t = lib.TIFFOpen(os.path.join(corpus.FOLDER, name).encode(), b"r")
            assert t, name
            if upsampled:
                lib.TIFFSetField(t, 65538, 1)       # JPEGCOLORMODE_RGB
            got = (lib.TIFFScanlineSize64(t), lib.TIFFTileSize64(t)
                   if ldir.tiled else lib.TIFFStripSize64(t))
            lib.TIFFClose(t)
            assert got == (tiff._scanline(ldir, upsampled),
                           tiff._chunk_size(ldir, upsampled)), name
            checked += 1
    assert checked > 100


# Each rule of Pillow's, libtiff's and libjpeg's that the corpus pins, and
# the corpus files whose routes change when the rule is mutated in a copy
# of yolov5m_tpu_torch/ (one mutation or a group a rule).
RULES = {
    "Pillow: Orientation applied by exif_transpose alone":
        ["lw_ycbcr11_jpeg_planar_rps5_37x29.tif",
        "pw_ycbcr_lzw_orient2_19x13.tif", "pw_ycbcr_lzw_orient3_19x13.tif",
        "pw_ycbcr_lzw_orient6_19x13.tif", "yc_lzw_22_orient2_19x13.tif",
        "yc_lzw_22_orient3_19x13.tif"],
    "Pillow: YCbCr but JPEG in one plane read by TIFFRGBAImage":
        ["hm_dup_compression_lzw_then_jpeg_19x13.tif",
        "lw_ycbcr11_jpeg_planar_37x29.tif",
        "lw_ycbcr11_jpeg_planar_rps5_37x29.tif",
        "lw_ycbcr11_jpeg_planar_tiles16_37x29.tif",
        "pw_ycbcr_adobe_deflate_19x13.tif", "pw_ycbcr_deflate_19x13.tif"],
    "Pillow: YCbCr under JPEG in one plane unpacked as RGB":
        ["hm_dup_compression_lzw_then_jpeg_19x13.tif",
        "hm_pil_baseline_wrapped_19x13.tif",
        "hm_pil_progressive_wrapped_19x13.tif",
        "hm_rgb_photometric_ycbcr_19x13.tif", "hm_tables_cut_in_dht_19x13.tif",
        "hm_tables_dqt_only_19x13.tif"],
    "libjpeg: tables carried from one stream to the next":
        ["hm_tables_in_strip0_only_19x13.tif",
        "hm_tables_redefined_strip0_19x13.tif"],
    "libtiff: CLAMPw holds the tables to +-4096":
        ["yc_lzw_21_refbw_flat_19x13.tif"],
    "libtiff: Code2V truncates the reference to an integer":
        ["yc_lzw_21_refbw_double_19x13.tif"],
    "libtiff: JCS_UNKNOWN passes the components as stored":
        ["hm_rgb_19x13.tif", "hm_rgb_adobe_ycc_19x13.tif",
        "hm_rgb_jfif_19x13.tif", "lw_rgb_jpeg_37x29.tif",
        "lw_rgb_jpeg_tiles16_be_37x29.tif", "pw_jpeg_rgb_orient1_19x13.tif"],
    "libtiff: JPEG's colour space from the TIFF, markers ignored":
        ["hm_ycbcr22_adobe_rgb_19x13.tif"],
    "libtiff: JPEGCOLORMODE_RGB's upsampled sizes":
        ["hm_pil_baseline_wrapped_19x13.tif",
        "hm_pil_progressive_wrapped_19x13.tif",
        "hm_rgb_photometric_ycbcr_19x13.tif", "hm_tables_cut_in_dht_19x13.tif",
        "hm_tables_dqt_only_19x13.tif", "hm_tables_in_strip0_only_19x13.tif"],
    "libtiff: JPEGFixupTags only where the tag was not read":
        ["hm_dup_subsampling_11_then_22_19x13.tif",
        "hm_ycbcr11_tag22_19x13.tif", "hm_ycbcr22_tag11_19x13.tif",
        "hm_ycbcr22_tag33_19x13.tif", "hm_ycbcr22_tag44_19x13.tif"],
    "libtiff: JPEGFixupTags reads the subsampling from the first SOF":
        ["hm_rgb_photometric_ycbcr_19x13.tif",
        "hm_ycbcr11_no_subsampling_tag_19x13.tif",
        "hm_ycbcr12_no_subsampling_tag_19x13.tif",
        "hm_ycbcr21_no_subsampling_tag_19x13.tif",
        "hm_ycbcr21_subsampling_count3_19x13.tif"],
    "libtiff: JPEGPreDecode's component count":
        ["hm_rgb_spp4_19x13.tif"],
    "libtiff: JPEGPreDecode's last strip may be taller":
        ["hm_ycbcr22_last_strip_taller_19x13.tif"],
    "libtiff: JPEGPreDecode's precision against BitsPerSample":
        ["hm_grey_bps12_19x13.tif"],
    "libtiff: JPEGPreDecode's sampling factors":
        ["hm_dup_photometric_2_then_6_19x13.tif",
        "hm_dup_subsampling_11_then_22_19x13.tif",
        "hm_ycbcr11_tag22_19x13.tif", "hm_ycbcr22_photometric_rgb_19x13.tif",
        "hm_ycbcr22_tag11_19x13.tif", "hm_ycbcr22_tag44_19x13.tif"],
    "libtiff: JPEGPreDecode's segment size check":
        ["hm_ycbcr22_stream_wider_19x13.tif",
        "hm_ycbcr22_strip0_taller_19x13.tif"],
    "libtiff: JPEGTables of BYTE or SHORT":
        ["hm_tables_type_byte_19x13.tif", "hm_tables_type_short_19x13.tif"],
    "libtiff: ReferenceBlackWhite's YCbCr default":
        ["hm_dup_compression_lzw_then_jpeg_19x13.tif",
        "pw_ycbcr_adobe_deflate_19x13.tif", "pw_ycbcr_deflate_19x13.tif",
        "pw_ycbcr_lzw_19x13.tif", "pw_ycbcr_lzw_orient2_19x13.tif",
        "pw_ycbcr_lzw_orient3_19x13.tif"],
    "libtiff: TIFFRGBAImage reads on past a chunk that fails":
        ["hm_dup_compression_lzw_then_jpeg_19x13.tif",
        "yc_lzw_22_rps4_strip0_cut_19x13.tif",
        "yc_lzw_22_rps4_strip1_cut_19x13.tif",
        "yc_lzw_22_tiles16_tile1_cut_40x20.tif",
        "yc_lzw_22_tiles16_tile1_past_end_40x20.tif"],
    "libtiff: TIFFRGBAImage's putters at 1x1-4x4 only (separate: 1x1)":
        ["yc_lzw_planar_sub22_19x13.tif"],
    "libtiff: TIFFRGBAImageGet fails where its first read does":
        ["yc_lzw_22_tiles16_tile0_past_end_40x20.tif"],
    "libtiff: TIFFScanlineSize of packed YCbCr":
        ["yc_deflate_44_rps4_19x13.tif", "yc_lzw_44_19x13.tif",
        "yc_lzw_44_rps5_19x13.tif", "yc_packbits_44_rps4_19x13.tif"],
    "libtiff: TIFFVStripSize/TileSize of packed YCbCr":
        ["hm_dup_compression_lzw_then_jpeg_19x13.tif",
        "yc_deflate_22_rps4_19x13.tif", "yc_deflate_42_rps4_19x13.tif",
        "yc_deflate_44_rps4_19x13.tif", "yc_lzw_12_19x13.tif",
        "yc_lzw_12_rps5_19x13.tif"],
    "libtiff: YCbCrSubsampling defaults to 2x2":
        ["yc_lzw_no_subsampling_tag_19x13.tif"],
    "libtiff: YCbCrSubsampling read only with a count of 2":
        ["hm_ycbcr21_subsampling_count3_19x13.tif"],
    "libtiff: _TIFFReadEncodedTileAndAllocBuffer's ratio check":
        ["yc_lzw_22_tile_length_huge_19x13.tif"],
    "libtiff: a JPEGTables stream ends at EOI (Bogus JPEGTables field)":
        ["hm_tables_holding_image_19x13.tif"],
    "libtiff: a fake EOI past the chunk (std_fill_input_buffer)":
        ["hm_tables_cut_in_dht_19x13.tif", "hm_tables_no_eoi_19x13.tif",
        "hm_ycbcr22_strip0_cut120_19x13.tif",
        "hm_ycbcr22_strip0_cut40_19x13.tif",
        "hm_ycbcr22_strip1_empty_scan_19x13.tif",
        "hm_ycbcr22_strip1_no_eoi_19x13.tif"],
    "libtiff: a green coefficient of 0 refused":
        ["yc_lzw_21_coeff_green_zero_19x13.tif"],
    "libtiff: jpeg_finish_decompress's failures ignored":
        ["hm_ycbcr22_bad_dht_before_eoi_19x13.tif",
        "hm_ycbcr22_second_sos_19x13.tif"],
    "libtiff: rationals read as float32":
        ["yc_lzw_21_refbw_rational_32x16.tif"],
    "libtiff: the 2x2 putter's odd column":
        ["yc_deflate_22_rps4_19x13.tif", "yc_deflate_22_tiles16_19x13.tif",
        "yc_lzw_22_19x13.tif", "yc_lzw_22_bigendian_19x13.tif",
        "yc_lzw_22_bigtiff_19x13.tif", "yc_lzw_22_orient1_19x13.tif"],
    "libtiff: the 4x4 putter skips 4x2 blocks":
        ["yc_lzw_44_tiles16_19x13.tif"],
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_cases_equal_jax(rule):
    for name in RULES[rule]:
        path = os.path.join(corpus.FOLDER, name)
        assert _port(path, _read(name)) == DIGESTS[name], name


def _jpeg_smaller(data: bytes) -> bool:
    """A JPEG chunk whose frame is narrower or shorter than its segment:
    libtiff leaves the rest of its buffer as it was, and Pillow's buffer
    starts uninitialised (its pixels there are not reproducible)."""
    try:
        ldir = tiff.libtiff_dir(data)
    except ValueError:
        return False
    if ldir.compression != 7:
        return False
    for i, (off, cnt) in enumerate(zip(ldir.offsets, ldir.counts)):
        chunk = data[off:off + cnt]
        for marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
            k = chunk.find(bytes([0xFF, marker]))
            if 0 <= k and k + 9 <= len(chunk):
                h, w = struct.unpack(">HH", chunk[k + 5:k + 9])
                seg_w, seg_h, _ = tiff._jpeg_segment(ldir, i)
                if w < seg_w or h < seg_h:
                    return True
    return False


def _equal_on_the_server_route(data: bytes):
    from yolov5m_tpu.serving.server import _decode_image

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = corpus.digest(_decode_image(data))
    saved = {k: sys.modules.get(k) for k in ("PIL", "PIL.Image")}
    sys.modules.update({"PIL": None, "PIL.Image": None})
    try:
        got = corpus.digest(native.decode_image(data))
    finally:
        sys.modules.update(saved)
    assert got == want


@st.composite
def encoded_files(draw):
    """A file of the numpy encoder: photometric, subsampling, quality,
    strips or tiles, tables, restarts, size."""
    photometric = draw(st.sampled_from((6, 6, 6, 2, 1)))
    sub = draw(st.sampled_from(((1, 1), (2, 1), (1, 2), (2, 2), (4, 1),
                                (4, 2))))
    h = draw(st.integers(1, 40))
    w = draw(st.integers(1, 40))
    rgb = corpus.picture(draw(st.integers(0, 9)), h, w)
    tile = draw(st.sampled_from((0, 0, 16, 32)))
    rps = draw(st.sampled_from((8, 16, 32, 64))) * (sub[1] if sub[1] > 1
                                                    else 1)
    return corpus.jpeg_tiff(
        rgb if photometric != 1 else rgb[..., 0], photometric,
        sub, quality=draw(st.integers(5, 100)), rows_per_strip=rps,
        tile=tile if tile >= 8 * sub[1] else 0,
        with_tables=draw(st.booleans()), restart=draw(st.integers(0, 3)))


@settings(max_examples=25, deadline=None, derandomize=True)
@given(data=encoded_files())
def test_random_encoded_files_equal_pillow(data):
    _equal_on_the_server_route(data)


@st.composite
def changed_files(draw):
    """A corpus file with one to three bytes changed."""
    data = bytearray(_read(draw(st.sampled_from(NAMES))))
    for _ in range(draw(st.integers(1, 3))):
        data[draw(st.integers(0, len(data) - 1))] = draw(st.integers(0, 255))
    return bytes(data)


@settings(max_examples=120, deadline=None, derandomize=True)
@given(data=changed_files())
def test_changed_bytes_equal_pillow(data):
    assume(not _jpeg_smaller(data))
    _equal_on_the_server_route(data)
