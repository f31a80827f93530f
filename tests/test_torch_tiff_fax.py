"""CCITT fax, ThunderScan and SGILog TIFF as the port reads them
(data/tiff.py, csrc/fax_decode.cc, csrc/tiff_decode.cc) against the JAX
package's routes, which hand TIFF to Pillow 12.1.0's TiffImagePlugin
over its bundled libtiff 4.7.1 (tif_fax3.c, tif_thunder.c, tif_luv.c),
on the same bytes, with PIL unimportable for the port.

Every file of the committed corpus (tests/torch_tiff_fax_corpus.py)
gives, bitwise, what each JAX route gives, or fails where it fails. Also:
the committed digests equal the JAX routes here and the generator remakes
the corpus byte for byte; every strip and tile of the corpus decodes as
the bundled libtiff's own TIFFReadEncodedStrip and TIFFReadEncodedTile
decode it (their return and their buffer); no such file reaches PIL, and
every compression Pillow's open knows has a route; SGILog is refused on
every route, and no other plugin of Pillow's takes a file that starts as
a TIFF does; for each rule the corpus pins, the files that fail when the
rule is mutated in a copy of the port; and a bounded sweep of corpus
files with changed bytes against Pillow.
"""

import ctypes
import functools
import io
import os
import sys
import tempfile
import warnings

import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings, strategies as st

from tests import torch_fax_codecs as fc
from tests import torch_tiff_corpus as tc
from tests import torch_tiff_fax_corpus as corpus
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


def _on_disk(name: str, data: bytes, tmp: str) -> str:
    path = os.path.join(tmp, name)
    with open(path, "wb") as f:
        f.write(data)
    return path


@pytest.mark.parametrize("name", NAMES)
def test_corpus_file_equals_jax(name):
    assert _port(os.path.join(corpus.FOLDER, name), _read(name)) == \
        DIGESTS[name]


def test_committed_digests_equal_jax_here():
    """The digests chip_smoke.py holds the port to are the JAX routes'
    pixels and sizes on this machine."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name in NAMES:
            assert DIGESTS[name] == tc.reference(
                os.path.join(corpus.FOLDER, name)), name


def test_corpus_remakes_exactly():
    made = corpus.cases()
    assert sorted(made) == NAMES
    for name, data in made.items():
        assert data == _read(name), name
    files = [n for n in os.listdir(corpus.FOLDER) if n != corpus.DIGESTS]
    assert sorted(files) == NAMES
    total = sum(os.path.getsize(os.path.join(corpus.FOLDER, n))
                for n in os.listdir(corpus.FOLDER))
    assert total < 500_000
    for scenes, rotated, prefixes in corpus.PHASES.values():
        assert set(scenes) | {rotated} <= set(NAMES)
        assert all(n.startswith(prefixes) for n in scenes)
    assert all(any(n.startswith(p) for _, _, ps in corpus.PHASES.values()
                   for p in ps) for n in NAMES)
    # no file's pixels depend on what the fax decoders' buffer held before
    # its first chunk (Pillow's uninitialised memory there)
    assert not [n for n in NAMES if _uninitialised(_read(n))]


@functools.cache
def _libtiff():
    """Pillow's bundled libtiff 4.7.1 (its dependencies loaded by PIL)."""
    from PIL import Image  # noqa: F401  (loads libtiff's dependencies)

    lib = ctypes.CDLL(tc.pillow_libtiff())
    vp = ctypes.c_void_p
    lib.TIFFOpen.restype = vp
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    for name in ("TIFFIsTiled", "TIFFNumberOfStrips", "TIFFNumberOfTiles"):
        getattr(lib, name).argtypes = [vp]
    for name in ("TIFFStripSize", "TIFFTileSize"):
        getattr(lib, name).argtypes = [vp]
        getattr(lib, name).restype = ctypes.c_int64
    for name in ("TIFFReadEncodedStrip", "TIFFReadEncodedTile"):
        getattr(lib, name).argtypes = [vp, ctypes.c_uint32, vp,
                                       ctypes.c_int64]
        getattr(lib, name).restype = ctypes.c_int64
    lib.TIFFClose.argtypes = [vp]
    lib.TIFFSetErrorHandler.restype = vp
    lib.TIFFSetErrorHandler.argtypes = [vp]
    lib.TIFFSetWarningHandler.restype = vp
    lib.TIFFSetWarningHandler.argtypes = [vp]
    return lib


def _libtiff_reads(path: str):
    """Each strip or tile as TIFFReadEncodedStrip/Tile reads it into one
    buffer, zeroed at first, as Pillow's loop reads them: (the returns,
    the buffer after each read)."""
    lib = _libtiff()
    errors = lib.TIFFSetErrorHandler(None)
    warns = lib.TIFFSetWarningHandler(None)
    try:
        tif = lib.TIFFOpen(path.encode(), b"rC")
        assert tif
        try:
            tiled = lib.TIFFIsTiled(tif)
            n = lib.TIFFNumberOfTiles(tif) if tiled else \
                lib.TIFFNumberOfStrips(tif)
            size = lib.TIFFTileSize(tif) if tiled else \
                lib.TIFFStripSize(tif)
            buf = np.zeros(size, np.uint8)
            read = lib.TIFFReadEncodedTile if tiled else \
                lib.TIFFReadEncodedStrip
            rets, bufs = [], []
            for i in range(n):
                rets.append(read(tif, i, buf.ctypes.data, size))
                bufs.append(buf.copy())
            return rets, bufs
        finally:
            lib.TIFFClose(tif)
    finally:
        lib.TIFFSetErrorHandler(errors)
        lib.TIFFSetWarningHandler(warns)


def _port_reads(data: bytes):
    """The port's decode of every chunk in order: (status, bytes) each."""
    ldir = tiff.libtiff_dir(data)
    n = len(ldir.offsets)
    index = list(range(n))
    size = tiff._chunk_size(ldir)
    occs = [tiff._occ(ldir, i, False) for i in index]
    fills = [tiff._fill(ldir, data, i, size) for i in index]
    out, cap, status = tiff._decode(data, ldir, index, fills, occs, 1,
                                    [k - 1 for k in index], False)
    return status, [out[k * cap:k * cap + occs[k]] for k in index], occs


@pytest.mark.parametrize("codec", (2, 3, 4, 32771, 32809))
def test_chunks_equal_libtiffs_own_reads(codec):
    """libtiff's own TIFFReadEncodedStrip and TIFFReadEncodedTile on every
    corpus file of the codec, through ctypes: the port's chunk fails where
    libtiff's read returns -1 (Group 4 past its first row, and any fax
    tile, do not fail: TIFFReadEncodedTile fails on 0 alone), and leaves
    the buffer as libtiff leaves it."""
    seen = 0
    for name in NAMES:
        data = _read(name)
        try:
            ldir = tiff.libtiff_dir(data)
        except ValueError:
            continue
        if ldir.compression != codec or (codec == 32809 and ldir.tiled) \
                or ldir.bps != (4 if codec == 32809 else 1):
            continue
        seen += 1
        rets, bufs = _libtiff_reads(os.path.join(corpus.FOLDER, name))
        status, outs, occs = _port_reads(data)
        assert [int(r != -1) for r in rets] == [1 - s for s in status], name
        for k, (ret, buf) in enumerate(zip(rets, bufs)):
            if ret != -1:
                assert np.array_equal(buf[:occs[k]], outs[k]), (name, k)
    assert seen >= 4


def test_corpus_covers_what_it_claims():
    """Each codec in strips (and the fax codecs in tiles), both fill
    orders, both photometric interpretations, T4Options 0, 1, 4 and 5,
    RowsPerStrip that does not divide the height, rows past 1728 and 2560
    pixels, odd strip offsets for RLEW; the refusals."""
    kinds, opts, fills, photos = set(), set(), set(), set()
    odd_rlew = 0
    for name in NAMES:
        data = _read(name)
        try:
            d = tiff.libtiff_dir(data)
        except ValueError:
            continue
        kinds.add((d.compression, d.tiled))
        fills.add((d.compression, d.fillorder))
        photos.add((d.compression, d.photometric))
        if d.compression == 3:
            opts.add(d.faxoptions)
        if d.compression == 32771 and any(o % 2 for o in d.offsets):
            odd_rlew += 1
    for codec in (2, 3, 4, 32771, 32809):
        assert {(codec, 1), (codec, 2)} <= fills, codec
        assert {(codec, 0), (codec, 1)} <= photos, codec
        assert (codec, False) in kinds and (codec, True) in kinds, codec
    assert opts >= {0, 1, 4, 5}
    assert odd_rlew >= 3
    widths = {tiff.libtiff_dir(_read(n)).width for n in NAMES
              if n.startswith("fx_lw_")}
    assert {1, 9, 37, 1800, 2000, 2700} <= widths
    refused = {n for n in NAMES if not DIGESTS[n]["img"]}
    assert {n for n in refused if n.startswith("sg_")} == \
        {n for n in NAMES if n.startswith("sg_")}
    assert {"th_short_8x8.tif", "th_run_past_row_8x8.tif",
            "th_8bit_37x29.tif", "th_tiles_37x29.tif",
            "fx_hm_g4_cut_first_row_37x13.tif",
            "fx_hm_g3_cut_at_code_37x13.tif",
            "fx_hm_g3_2d_cut_at_code_37x13.tif", "fx_hm_rle_cut_37x13.tif",
            "fx_hm_rlew_cut_37x13.tif", "fx_lw_g4_8bit_7x5.tif",
            "fx_lw_rle_rgb_7x5.tif"} <= refused
    # read: Group 3 cut inside a code, Group 4 cut past its first row, fax
    # tiles that fail
    for name in ("fx_hm_g3_cut_37x13.tif", "fx_hm_g3_2d_cut_37x13.tif",
                 "fx_hm_g4_cut_last_row_37x13.tif",
                 "fx_hm_g4_early_cut_37x13.tif",
                 "fx_hm_g4_tiles_cut_45x40.tif",
                 "fx_hm_rle_tiles_cut_45x40.tif"):
        assert DIGESTS[name]["img"], name


def test_flagship_scenes_equal_pillow():
    """The 640x480 scenes decode on every route to Pillow's pixels at
    Pillow's size, the rotated ones upright."""
    for scenes, rotated, _ in corpus.PHASES.values():
        for name in scenes + (rotated,):
            assert DIGESTS[name]["hw"] == ([480, 640] if name != rotated
                                           else [640, 480]), name
            assert _port(os.path.join(corpus.FOLDER, name),
                         _read(name)) == DIGESTS[name], name


def test_every_compression_has_a_route():
    """Every compression Pillow's open knows is read, or refused, here:
    none is left to PIL by its tags."""
    assert set(tiff.COMPRESSION_INFO.values()) == set(tiff.DECODED)
    for code, name in tiff.COMPRESSION_INFO.items():
        assert tiff.DECODED[name] == code
    rgb = tc.libtiff(tc.picture(60, 5, 9), photometric=2, rows_per_strip=5)
    for code in tiff.COMPRESSION_INFO:
        data = tc.patched(rgb, 259, code)
        assert tiff.route(tiff.open_tiff(data), data) is not None, code


def test_no_fax_reaches_pil(monkeypatch):
    """Every corpus file goes to the port's decoders, or is refused, though
    PIL is importable: _decode_other is never called for these
    compressions, on any route."""
    handed = []
    monkeypatch.setattr(native, "_decode_other",
                        lambda data: handed.append(data))
    with tempfile.TemporaryDirectory() as tmp:
        for name in NAMES:
            data = _read(name)
            path = _on_disk(name, data, tmp)
            native.decode_image(data)
            native.decode_image(data, by_path=True)
            _attempt(native.load_image_pillow, path)
            _attempt(native.load_image_rgb, path)
            _attempt(native.read_image_size, path)
    assert not handed


# Pillow 12.1.0's plugins whose _accept takes a file that starts with one
# of the TIFF prefixes (IM, IMT, IPTC, PCD, SPIDER and TGA have no _accept:
# their _open refuses the corpus' LogL and LogLuv files, below)
ACCEPTING_A_TIFF_PREFIX = ["TIFF"]


def test_pillows_other_plugins_refuse_a_tiff():
    """The list of Pillow's plugins whose _accept takes a TIFF prefix;
    every one but TIFF (and every plugin without an _accept) refuses the
    corpus' SGILog files that the TIFF plugin passes on, so Pillow's open
    fails, and the port refuses them itself."""
    from PIL import Image

    Image.init()
    accepting = []
    for fmt, (_, accept) in sorted(Image.OPEN.items()):
        if accept is not None and any(accept(p + bytes(28))
                                      for p in tiff.PREFIXES):
            accepting.append(fmt)
    assert accepting == ACCEPTING_A_TIFF_PREFIX
    for name in NAMES:
        if not name.endswith(("logl_11x9.tif", "logluv_11x9.tif")):
            continue
        with pytest.raises(Image.UnidentifiedImageError):
            Image.open(io.BytesIO(_read(name)))


def test_sgilog_refused_on_every_route(tmp_path):
    """SGILog under a photometric Pillow opens: refused at load, the size
    read; under LogL or LogLuv: refused at open on every route (the
    server answers None, the loader and detect --img raise, no size)."""
    for name in NAMES:
        if not name.startswith("sg_"):
            continue
        data = _read(name)
        path = _on_disk(name, data, str(tmp_path))
        assert native.decode_image(data) is None, name
        with pytest.raises(ValueError):
            native.load_image_rgb(path)
        with pytest.raises(ValueError):
            native.load_image_pillow(path)
        passed_on = name.endswith(("logl_11x9.tif", "logluv_11x9.tif"))
        if passed_on:
            with pytest.raises(ValueError):
                native.read_image_size(path)
        else:
            assert native.read_image_size(path) == (9, 11), name


# Each rule of libtiff's and Pillow's that the corpus pins, and the corpus
# files whose routes change when the rule is mutated in a copy of
# yolov5m_tpu_torch/ (one mutation a rule).
RULES = {
    "CHECK_b1: b1 the reference line's next change of the other colour":
        ["fx_hm_g3_2d_bad_vl_37x13.tif",
        "fx_hm_g3_2d_cut_37x13.tif",
        "fx_hm_g3_2d_eol_in_row_37x13.tif",
        "fx_hm_g3_2d_k2_fill_fo2_37x13.tif",
        "fx_hm_g3_2d_long_row_37x13.tif",
        "fx_hm_g3_2d_rtc_37x13.tif",
        "fx_hm_g3_2d_t4_dup_first1_37x13.tif",
        "fx_hm_g3_2d_t4_short_37x13.tif"],
    "CLEANUP_RUNS: a row past its width clipped":
        ["fx_hm_g3_2d_cut_37x13.tif",
        "fx_hm_g3_2d_t4_count2_37x13.tif",
        "fx_hm_g3_2d_t4_dup_first0_37x13.tif",
        "fx_hm_g3_2d_t4_ifd_37x13.tif",
        "fx_hm_g3_cut_37x13.tif",
        "fx_hm_g3_eols_stop_37x13.tif",
        "fx_hm_g3_trailing_zeros_37x13.tif",
        "fx_hm_g4_long_row_37x13.tif"],
    "CLEANUP_RUNS: a row short of its width padded white":
        ["fx_hm_g3_2d_bad_vl_37x13.tif",
        "fx_hm_g3_2d_cut_37x13.tif",
        "fx_hm_g3_2d_eol_in_row_37x13.tif",
        "fx_hm_g3_cut_37x13.tif",
        "fx_hm_g3_eols_stop_37x13.tif",
        "fx_hm_g3_trailing_zeros_37x13.tif",
        "fx_hm_g4_bad_horizontal_37x13.tif",
        "fx_hm_g4_long_row_37x13.tif"],
    "EXPAND2D: a VL left of a0 ends its row":
        ["fx_hm_g4_long_row_37x13.tif"],
    "EXPAND2D: an EOL in a row ends it, the open run to the row's end":
        ["fx_hm_g3_2d_eol_in_row_37x13.tif"],
    "Fax3Decode1D, 2D and RLE: no bit left at a code's read refuses":
        ["fx_hm_g3_2d_cut_at_code_37x13.tif",
        "fx_hm_g3_2d_no_bit_at_eol_1x4.tif",
        "fx_hm_g3_cut_at_code_37x13.tif",
        "fx_hm_rle_cut_37x13.tif",
        "fx_hm_rlew_cut_37x13.tif",
        "fx_lw_rlew_p0_fo1_37x29.tif",
        "fx_lw_rlew_p0_fo2_37x29.tif",
        "fx_lw_rlew_p1_fo1_37x29.tif"],
    "Fax3Decode2D: a tag bit after each EOL, 1 for a 1D row":
        ["fx_hm_g3_2d_bad_vl_37x13.tif",
        "fx_hm_g3_2d_cut_37x13.tif",
        "fx_hm_g3_2d_eol_in_row_37x13.tif",
        "fx_hm_g3_2d_k2_fill_fo2_37x13.tif",
        "fx_hm_g3_2d_long_row_37x13.tif",
        "fx_hm_g3_2d_rtc_37x13.tif",
        "fx_hm_g3_2d_t4_dup_first1_37x13.tif",
        "fx_hm_g3_2d_t4_short_37x13.tif"],
    "Fax3DecodeRLE (RLE): a row's end aligned to a byte":
        ["fx_hm_rle_bad_code_37x11.tif",
        "fx_hm_rle_cut_37x13.tif",
        "fx_hm_rle_p1_fo2_odd_37x11.tif",
        "fx_hm_rle_t4options1_37x13.tif",
        "fx_hm_rle_tiles_cut_45x40.tif",
        "fx_hm_rle_unaligned_37x11.tif",
        "fx_lw_rle_2700x3.tif",
        "fx_lw_rle_p0_fo1_37x29.tif"],
    "Fax3Extension: the uncompressed-mode extension ends its row":
        ["fx_hm_g3_2d_uncompressed_37x13.tif",
        "fx_hm_g4_uncompressed_37x13.tif"],
    "Fax3PreDecode: the reference line white at each strip's or tile's start":
        ["fx_hm_g4_bad_horizontal_37x13.tif",
        "fx_hm_g4_cut_last_row_37x13.tif",
        "fx_hm_g4_early_cut_37x13.tif",
        "fx_hm_g4_early_eofb_37x13.tif",
        "fx_hm_g4_eofb_37x13.tif",
        "fx_hm_g4_eofb_fo2_37x13.tif",
        "fx_hm_g4_long_row_37x13.tif",
        "fx_hm_g4_predictor2_37x13.tif"],
    "Fax3SetupState fails before TIFFRGBAImage's buffer: it stops":
        ["fx_lw_g4_ycbcr_10x8.tif"],
    "Fax3SetupState: 1 bit a sample alone, every read refused":
        ["fx_lw_g4_8bit_7x5.tif",
        "fx_lw_g4_ycbcr_10x8.tif",
        "fx_lw_rle_rgb_7x5.tif"],
    "Fax3Unexpected: a bad code word ends its row, not the decode":
        ["fx_hm_g3_2d_bad_vl_37x13.tif",
        "fx_hm_g3_2d_cut_37x13.tif",
        "fx_hm_g3_2d_eol_in_row_37x13.tif",
        "fx_hm_g3_bad_black_37x13.tif",
        "fx_hm_g3_bad_white_37x13.tif",
        "fx_hm_g4_bad_horizontal_37x13.tif",
        "fx_hm_g4_long_row_37x13.tif",
        "fx_hm_g4_tiles_cut_45x40.tif"],
    "Fax4Decode: an end past the first row reads, before it refuses":
        ["fx_hm_g4_bad_horizontal_37x13.tif",
        "fx_hm_g4_cut_first_row_37x13.tif",
        "fx_hm_g4_cut_last_row_37x13.tif",
        "fx_hm_g4_early_cut_37x13.tif",
        "fx_hm_g4_early_eofb_37x13.tif"],
    "Group 3 without an EOL: read again from the chunk's first bit":
        ["fx_hm_g3_2d_cut_37x13.tif",
        "fx_hm_g3_cut_37x13.tif",
        "fx_hm_g3_eols_stop_37x13.tif",
        "fx_hm_g3_no_eols_37x13.tif",
        "fx_hm_g3_no_eols_fo2_37x13.tif",
        "fx_hm_g3_no_first_eol_37x13.tif",
        "fx_hm_g3_trailing_zeros_37x13.tif"],
    "Group 3 without an EOL: the chunks after it read without EOLs":
        ["fx_hm_g3_2d_cut_37x13.tif",
        "fx_hm_g3_cut_37x13.tif",
        "fx_hm_g3_eols_stop_37x13.tif",
        "fx_hm_g3_trailing_zeros_37x13.tif"],
    "LogLuvSetupDecode: SGILog refused under Pillow's photometrics":
        ["sg_34676_bilevel_11x9.tif",
        "sg_34676_grey_11x9.tif",
        "sg_34676_rgb_11x9.tif",
        "sg_34677_bilevel_11x9.tif",
        "sg_34677_grey_11x9.tif",
        "sg_34677_rgb_11x9.tif"],
    "NeedBits8 and NeedBits16: zero bits padded while any bit is left":
        ["fx_hm_g3_2d_bad_vl_37x13.tif",
        "fx_hm_g3_2d_cut_37x13.tif",
        "fx_hm_g3_2d_k2_fill_fo2_37x13.tif",
        "fx_hm_g3_2d_long_row_37x13.tif",
        "fx_hm_g3_2d_t4_dup_first1_37x13.tif",
        "fx_hm_g3_2d_t4_short_37x13.tif",
        "fx_hm_g3_2d_t4_signed_37x13.tif",
        "fx_hm_g3_2d_tiles_45x40.tif"],
    "Pillow: fill order 2 opened with fill order 1's unpacker":
        ["fx_hm_g3_2d_k2_fill_fo2_37x13.tif",
        "fx_hm_g3_no_eols_fo2_37x13.tif",
        "fx_hm_g4_eofb_fo2_37x13.tif",
        "fx_hm_rle_p1_fo2_odd_37x11.tif",
        "fx_hm_rlew_even_fo2_37x11.tif",
        "fx_hm_rlew_odd_fo2_37x11.tif",
        "fx_lw_g3_2d_fill_p0_fo2_37x29.tif",
        "fx_lw_g3_2d_fill_p1_fo2_37x29.tif"],
    "RLEW: a row's end aligned to 16 bits by its address (offset parity)":
        ["fx_hm_rlew_odd_fo1_37x11.tif",
        "fx_hm_rlew_odd_fo2_37x11.tif",
        "fx_hm_rlew_raw_strips_37x11.tif",
        "fx_hm_rlew_two_strips_37x11.tif"],
    "SYNC_EOL: no bit left as the EOL search starts refuses the strip":
        ["fx_hm_g3_2d_no_bit_at_eol_1x4.tif"],
    "SYNC_EOL: the zero bits before an EOL (fill bits) skipped one by one":
        ["fx_hm_g3_2d_bad_vl_37x13.tif",
        "fx_hm_g3_2d_eol_in_row_37x13.tif",
        "fx_hm_g3_2d_long_row_37x13.tif",
        "fx_hm_g3_2d_no_bit_at_eol_1x4.tif",
        "fx_hm_g3_2d_t4_count2_37x13.tif",
        "fx_hm_g3_2d_t4_dup_first0_37x13.tif",
        "fx_hm_g3_2d_t4_ifd_37x13.tif",
        "fx_hm_g3_2d_uncompressed_37x13.tif"],
    "T.4's extended make-up codes (1792-2560) in both colours' tables":
        ["fx_lw_g4_2700x3.tif",
        "fx_lw_rle_2700x3.tif"],
    "TIFFFillStrip: ThunderScan's bytes reversed for fill order 2":
        ["th_codes_fo2_8x8.tif",
        "th_p0_fo2_37x29.tif",
        "th_p1_fo2_37x29.tif"],
    "TIFFReadEncodedTile: a fax tile's decode never fails":
        ["fx_hm_rle_tiles_cut_45x40.tif",
        "fx_hm_rlew_tiles_45x40.tif"],
    "ThunderDecode: a run from an odd pixel, the n == -1 fix-up":
        ["scene_thunder_640x480.tif",
        "scene_thunder_orient6_640x480.tif",
        "th_codes_8x8.tif",
        "th_codes_fo2_8x8.tif",
        "th_extra_bytes_8x8.tif",
        "th_p0_fo1_37x29.tif",
        "th_p0_fo2_37x29.tif",
        "th_p1_fo1_37x29.tif"],
    "ThunderDecode: a run that ends its row written":
        ["th_codes_8x8.tif",
        "th_codes_fo2_8x8.tif",
        "th_extra_bytes_8x8.tif",
        "th_p0_fo1_37x29.tif",
        "th_p0_fo2_37x29.tif",
        "th_p1_fo1_37x29.tif",
        "th_p1_fo2_37x29.tif",
        "th_palette_37x29.tif"],
    "ThunderDecode: deltas wrap modulo 16":
        ["scene_thunder_640x480.tif",
        "scene_thunder_orient6_640x480.tif",
        "th_codes_8x8.tif",
        "th_codes_fo2_8x8.tif",
        "th_extra_bytes_8x8.tif",
        "th_odd_9x7.tif",
        "th_p0_fo1_37x29.tif",
        "th_p0_fo2_37x29.tif"],
    "ThunderDecode: lastpixel and npixels from 0 at each row":
        ["th_codes_8x8.tif",
        "th_codes_fo2_8x8.tif",
        "th_extra_bytes_8x8.tif",
        "th_odd_9x7.tif",
        "th_p0_fo1_37x29.tif",
        "th_p0_fo2_37x29.tif",
        "th_p1_fo1_37x29.tif",
        "th_p1_fo2_37x29.tif"],
    "ThunderDecode: the 2-bit deltas' skip code":
        ["th_codes_8x8.tif",
        "th_codes_fo2_8x8.tif",
        "th_extra_bytes_8x8.tif"],
    "ThunderDecode: the 3-bit deltas' skip code":
        ["th_codes_8x8.tif",
        "th_codes_fo2_8x8.tif",
        "th_extra_bytes_8x8.tif"],
    "ThunderDecodeRow: a row short of or past its pixels refuses the strip":
        ["th_run_past_row_8x8.tif",
        "th_short_8x8.tif"],
    "ThunderScan: tile decoding not implemented, tiles refused":
        ["th_tiles_16x32.tif"],
    "ThunderSetupDecode: 4 bits a sample alone, every read refused":
        ["th_8bit_37x29.tif",
        "th_ycbcr_10x8.tif"],
    "_TIFFFax3fillruns: black runs set their bits, leaving the byte's others":
        ["fx_hm_g3_2d_bad_vl_37x13.tif",
        "fx_hm_g3_2d_cut_37x13.tif",
        "fx_hm_g3_2d_eol_in_row_37x13.tif",
        "fx_hm_g3_2d_k2_fill_fo2_37x13.tif",
        "fx_hm_g3_2d_long_row_37x13.tif",
        "fx_hm_g3_2d_rtc_37x13.tif",
        "fx_hm_g3_2d_t4_dup_first1_37x13.tif",
        "fx_hm_g3_2d_t4_short_37x13.tif"],
    "fax codec: fill order 2 as it is (TIFF_NOBITREV), 1 bit-reversed":
        ["fx_hm_g3_2d_k2_fill_fo2_37x13.tif",
        "fx_hm_g3_no_eols_fo2_37x13.tif",
        "fx_hm_g4_eofb_fo2_37x13.tif",
        "fx_hm_rle_p1_fo2_odd_37x11.tif",
        "fx_hm_rlew_even_fo2_37x11.tif",
        "fx_hm_rlew_odd_fo2_37x11.tif",
        "fx_lw_g3_2d_fill_p0_fo2_37x29.tif",
        "fx_lw_g3_2d_fill_p1_fo2_37x29.tif"],
    "libtiff's directory: Predictor no field of the fax codecs":
        ["fx_hm_g4_predictor2_37x13.tif"],
    "libtiff's directory: T4Options bit 0 picks Fax3Decode2D":
        ["fx_hm_g3_2d_bad_vl_37x13.tif",
        "fx_hm_g3_2d_cut_37x13.tif",
        "fx_hm_g3_2d_cut_at_code_37x13.tif",
        "fx_hm_g3_2d_eol_in_row_37x13.tif",
        "fx_hm_g3_2d_k2_fill_fo2_37x13.tif",
        "fx_hm_g3_2d_long_row_37x13.tif",
        "fx_hm_g3_2d_no_bit_at_eol_1x4.tif",
        "fx_hm_g3_2d_rtc_37x13.tif"],
    "libtiff's directory: T4Options of a count other than 1 ignored":
        ["fx_hm_g3_2d_t4_count2_37x13.tif"],
    "libtiff's directory: T4Options of an IFD type ignored":
        ["fx_hm_g3_2d_t4_count2_37x13.tif",
        "fx_hm_g3_2d_t4_ifd_37x13.tif"],
    "libtiff's directory: T4Options, the first of duplicate entries":
        ["fx_hm_g3_2d_t4_dup_first0_37x13.tif",
        "fx_hm_g3_2d_t4_dup_first1_37x13.tif"],
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_cases_equal_jax(rule):
    assert RULES[rule]
    for name in RULES[rule]:
        assert _port(os.path.join(corpus.FOLDER, name), _read(name)) == \
            DIGESTS[name], name


def _changed(draw, data: bytes, lo: int) -> bytes:
    """data with one to eight bytes from lo on changed, or one bit
    flipped."""
    out = bytearray(data)
    flip = draw(st.booleans())
    for _ in range(1 if flip else draw(st.integers(1, 8))):
        at = draw(st.integers(lo, len(out) - 1))
        out[at] = out[at] ^ (1 << draw(st.integers(0, 7))) if flip \
            else draw(st.integers(0, 255))
    return bytes(out)


@st.composite
def changed_files(draw):
    name = draw(st.sampled_from([n for n in NAMES
                                 if not n.startswith("scene")]))
    data = _read(name)
    try:
        first = min(tiff.libtiff_dir(data).offsets)
    except ValueError:
        first = 8
    # the codes mostly, and now and then the header and directory
    lo = 0 if draw(st.integers(0, 3)) == 0 else min(first, len(data) - 1)
    return name, _changed(draw, data, lo)


def _uninitialised(data: bytes) -> bool:
    """The port's pixels depend on what the fax decoders' buffer held
    before the first chunk (a Group 4 chunk ended before its rows, a fax
    tile that failed): Pillow's are uninitialised memory there."""
    saved = tiff.FAX_BUFFER_FILL
    try:
        got = []
        for fill in (0, 255):
            tiff.FAX_BUFFER_FILL = fill
            got.append(corpus.digest(native.decode_image(data)))
    finally:
        tiff.FAX_BUFFER_FILL = saved
    return got[0] != got[1]


@settings(max_examples=40, deadline=None, derandomize=True)
@given(case=changed_files())
def test_changed_bytes_equal_pillow(case):
    """Corpus files with bytes changed: every route equals Pillow's."""
    name, data = case
    assume(not _uninitialised(data))
    with tempfile.TemporaryDirectory() as tmp:
        path = _on_disk(name, data, tmp)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = tc.reference(path)
        assert _port(path, data) == want


def test_encoder_codes_are_prefix_free():
    """The test-side encoder's code words: each colour's run codes and the
    2D mode codes are prefix-free sets (so a stream written here means
    what it says), and every run 0-2560 round-trips through span."""
    for codes in (fc.WHITE_TERM + fc.WHITE_MAKEUP + fc.EXT_MAKEUP,
                  fc.BLACK_TERM + fc.BLACK_MAKEUP + fc.EXT_MAKEUP,
                  (fc.PASS, fc.HORIZ, fc.EXTENSION,
                   *fc.VERTICAL.values())):
        for a in codes:
            for b in codes:
                assert a == b or not b.startswith(a), (a, b)
    rows = np.zeros((1, 2700), np.uint8)
    rows[0, 2600:] = 1
    data = corpus.fax_file(rows, 2, 1)
    assert np.array_equal(
        tiff.decode(data)[..., 0], np.where(rows == 1, 0, 255))
