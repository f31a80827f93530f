"""TIFF as the port reads it (data/tiff.py, the codecs in
csrc/tiff_decode.cc) against the JAX package's routes, which hand TIFF to
Pillow 12.1.0's TiffImagePlugin (over its bundled libtiff 4.7.1 where the
file is compressed), on the same bytes, with PIL unimportable for the
port.

Every file of the committed corpus (tests/torch_tiff_corpus.py) gives,
bitwise, what each JAX route gives, or fails where it fails: the server's
``_decode_image`` on the bytes (the port's decode_image), the loader's
``load_image_rgb`` and detect ``--img``'s ``Image.open(path)
.convert("RGB")`` on the path (load_image_rgb and load_image_pillow; Pillow
maps an uncompressed single-strip file opened by its path) and the
dataset's ``_read_image_size`` (read_image_size). The committed digests,
which chip_smoke.py holds the port to on a machine without Pillow, equal
the JAX routes here, and the generator remakes the corpus byte for byte.
Also: every cut of one file of each codec; hypothesis sweeps of the
libtiff writer's settings and of bytes changed in the corpus' files; every
unpacker and conversion against ``Image.frombytes``; the files whose tags
the port leaves to PIL reach it by those tags alone, and no other does;
for each of Pillow's and libtiff's rules the corpus pins, the files that
fail when the rule is mutated in a copy of the port.
"""

import functools
import io
import logging
import os
import sys
import threading
import warnings

import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings, strategies as st
from PIL import Image, UnidentifiedImageError

from tests import torch_jpeg_fixtures
from tests import torch_tiff_corpus as corpus
from yolov5m_tpu_torch.data import convert, formats, native, tiff

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


def _sha(img):
    return None if img is None else corpus.hashlib.sha256(
        np.ascontiguousarray(img).tobytes()).hexdigest()


def _port(path: str, data: bytes) -> dict:
    """Each of the port's routes (the digest of its pixels, the size)."""
    hw = _attempt(native.read_image_size, path)
    return {"loader": _sha(native.decode_image(data)),
            "load": _sha(_attempt(native.load_image_rgb, path)),
            "img": _sha(_attempt(native.load_image_pillow, path)),
            "hw": None if hw is None else list(hw)}


def _no_pil(monkeypatch):
    for name in ("PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)


def _port_no_pil(path: str, data: bytes) -> dict:
    saved = {k: sys.modules.get(k) for k in ("PIL", "PIL.Image")}
    sys.modules.update({"PIL": None, "PIL.Image": None})
    try:
        return _port(path, data)
    finally:
        sys.modules.update(saved)


def _jax(path: str) -> dict:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return corpus.reference(path)


def _left(data: bytes) -> bool:
    """The file's tags leave it to PIL. No TIFF codec is left any more:
    every compression Pillow's open knows (the fax, ThunderScan and SGILog
    codecs, old-style JPEG, ZSTD, LZMA and WebP among them) is read or
    refused by the port, so only a compression that libtiff's directory
    reads otherwise than Pillow's open could be."""
    try:
        return tiff.route(tiff.open_tiff(data), data) is None
    except (tiff.NotTiff, ValueError):
        return False


def _write(tmp_path, data: bytes, name: str = "f.tif") -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


@pytest.mark.parametrize("name", NAMES)
def test_corpus_file_equals_jax(name, monkeypatch):
    """Every route with PIL blocked gives the committed JAX digests; a file
    whose tags the port leaves to PIL is refused without it, and only
    such files differ."""
    path = os.path.join(corpus.FOLDER, name)
    data = _read(name)
    with monkeypatch.context() as m:
        _no_pil(m)
        got = _port(path, data)
    want = DIGESTS[name]
    if _left(data):
        assert got == {"loader": None, "load": None, "img": None,
                       "hw": want["hw"]}
        assert name.startswith(("hw_left_", "hw_raw_planar_lab")), name
    else:
        assert got == want


def _pillow_kind(data: bytes) -> str:
    """"tiff" where Pillow's TIFF plugin opens the file, "refused" where
    Image.open fails, "passed on" where the plugin passes it to the other
    plugins (none of which reads it here)."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with Image.open(io.BytesIO(data)) as im:
                assert im.format == "TIFF", im.format
        return "tiff"
    except UnidentifiedImageError:
        return "passed on"
    except Exception:  # Pillow raises many types on corrupt input
        return "refused"


def _port_kind(data: bytes) -> str:
    try:
        tiff.open_tiff(data)
        return "tiff"
    except tiff.NotTiff:
        return "passed on"
    except ValueError:
        return "refused"


@pytest.mark.parametrize("name", NAMES)
def test_open_passes_on_where_pillow_does(name):
    assert _port_kind(_read(name)) == _pillow_kind(_read(name))


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
    assert sum(len(d) for d in made.values()) < 700_000


def test_corpus_covers_what_it_claims():
    """Every codec and predictor, both byte orders, BigTIFF, tiles and
    planes, every mode of OPEN_INFO but LAB decoded on some route; files
    refused at open, at load and passed on."""
    headers = {}
    for name in NAMES:
        try:
            headers[name] = tiff.open_tiff(_read(name))
        except (tiff.NotTiff, ValueError):
            pass
    decoded = {n for n in NAMES if DIGESTS[n]["img"]}
    # JPEG: the corpus of tests/test_torch_tiff_jpeg.py; LZMA, ZSTD and
    # WebP: that of tests/test_torch_tiff_zstd_lzma.py; old-style JPEG:
    # that of tests/test_torch_tiff_ojpeg.py; the fax codecs, ThunderScan
    # and SGILog: that of tests/test_torch_tiff_fax.py
    assert {headers[n].compression for n in decoded} >= \
        set(tiff.DECODED) - {"jpeg", "lzma", "zstd", "webp", "tiff_jpeg",
                             "tiff_ccitt", "group3", "group4", "tiff_raw_16",
                             "tiff_thunderscan", "tiff_sgilog",
                             "tiff_sgilog24"}
    assert {headers[n].mode for n in decoded} >= set(tiff._IMAGE_BANDS) - \
        {"LAB"}
    assert {headers[n].rawmode for n in decoded if not _left(_read(n))} >= {
        "1;I", "L;2", "L;4I", "I;12", "I;16N", "I;16B", "I;16S", "I;32N",
        "I;32BS", "F;32F", "F;32BF", "RGBa", "RGBXXX", "RGBaX", "RGBAXX",
        "RGB;16N", "RGBa;16N", "CMYKX", "CMYK;16N", "P;1", "P;2", "P;4",
        "PA", "LA", "RGB;R", "L;R"}
    ldirs = {n: tiff.libtiff_dir(_read(n)) for n in decoded
             if headers[n].compression != "raw"}
    assert {d.predictor for d in ldirs.values()} == {1, 2, 3}
    assert {d.tiled for d in ldirs.values()} == {False, True}
    assert {d.planar for d in ldirs.values()} == {1, 2}
    assert {d.swap for d in ldirs.values()} == {False, True}
    assert any(_read(n)[2] == 43 for n in ldirs)
    refused_at_load = {n for n in NAMES if DIGESTS[n]["hw"]
                       and not DIGESTS[n]["img"]}
    assert len(refused_at_load) > 40
    passed_on = [n for n in NAMES if not DIGESTS[n]["hw"]]
    assert len(passed_on) > 10
    # the memory map: Orientation 5-8 of one strip of L differ by route
    assert {n for n in NAMES if DIGESTS[n]["loader"] !=
            DIGESTS[n]["load"]} == {
        f"pw_orient{o}_l_raw_19x13.tif" for o in (5, 6, 7, 8)}


@pytest.mark.parametrize("name", sorted(SCENE_DIGESTS))
def test_scene_equals_committed_digests(name, tmp_path, monkeypatch):
    """The 640x480 scenes chip_smoke.py remakes on the card: the digests
    it holds them to are Pillow's, and the port's."""
    data = _scenes()[name]
    path = _write(tmp_path, data, name)
    assert _jax(path) == SCENE_DIGESTS[name]
    with monkeypatch.context() as m:
        _no_pil(m)
        assert _port(path, data) == SCENE_DIGESTS[name]


def test_scenes_are_the_scene():
    rgb = torch_jpeg_fixtures.scene(0)
    got = {n: tiff.decode(d) for n, d in _scenes().items()}
    grey = (rgb.astype(np.int64).sum(-1) // 3).astype(np.uint8)
    for name, img in got.items():
        want = np.repeat(grey[..., None], 3, 2) if "grey" in name else rgb
        np.testing.assert_array_equal(img, want, err_msg=name)


@pytest.mark.parametrize("name", corpus.CUT_SOURCES)
def test_every_cut_equals_jax(name, tmp_path):
    full = _read(name)
    path = str(tmp_path / "cut.tif")
    for cut in range(len(full)):
        data = full[:cut]
        with open(path, "wb") as f:
            f.write(data)
        assert _port_no_pil(path, data) == _jax(path), cut


# each rule of Pillow's plugin and loader, libtiff's directory and codecs,
# and Pillow's TiffDecode.c the port follows, with corpus files that fail
# when the rule is mutated in a copy of yolov5m_tpu_torch/
RULES = {
    "open: IFD0 read as far as it goes (a cut directory)":
        ["hw_ifd_cut_before_next_7x5.tif"],
    "open: a tag's data past the end of the file stops the read":
        ["hw_description_past_end_7x5.tif"],
    "open: the last of duplicate tags":
        ["hw_duplicate_width_7x5.tif"],
    "open: no IFD, or one past the end, passes the file on":
        ["hw_ifd_offset0_7x5.tif", "hw_ifd_past_end_7x5.tif"],
    "open: big-endian BigTIFF read as classic (ifh[2] == 43)":
        ["lt_be_bigtiff_rgb_lzw_37x21.tif"],
    "open: COMPRESSION_INFO, its KeyError passing the file on":
        ["hw_unknown_compression_7x5.tif", "hw_pixarlog_7x5.tif"],
    "open: an ASCII value looked up in the tag's enum":
        ["hw_ascii_compression_raw_7x5.tif"],
    "open: the dimensions must be ints":
        ["hw_byte_width_7x5.tif", "hw_rational_width_7x5.tif"],
    "open: a size below 1 passes the file on":
        ["hw_width0_7x5.tif", "hw_missing_length_7x5.tif"],
    "open: BitsPerSample trimmed to SamplesPerPixel, or repeated":
        ["hw_bps_count4_spp3_7x5.tif", "hw_bps_one_spp3_7x5.tif"],
    "open: SampleFormat (1, 1, 1) is (1,)":
        ["hw_sampleformat_111_7x5.tif"],
    "open: OPEN_INFO, an unknown key passing the file on":
        ["hw_unknown_mode_7x5.tif", "hw_sampleformat_0_lzw_7x5.tif"],
    "open: the palette is ColorMap // 256, and needed":
        ["hw_palette8_raw_7x5.tif", "hw_palette_no_map_7x5.tif",
         "hw_colormap_float_7x5.tif"],
    "open: Windows Media Photo refused":
        ["hw_windows_media_photo_7x5.tif"],
    "open: the decompression-bomb limit":
        ["hw_bomb_7x5.tif"],
    "open: Orientation 5-8 swap the size":
        ["pw_orient6_rgb_raw_19x13.tif", "hw_orient_rational6_7x5.tif",
         "hw_orient_count2_7x5.tif"],
    "load: exif_transpose of Orientation 2-8":
        ["pw_orient2_rgb_lzw_19x13.tif", "pw_orient5_rgb_lzw_19x13.tif",
         "pw_orient7_rgb_raw_19x13.tif", "pw_orient8_rgb_raw_19x13.tif",
         "lt_orient6_tiles_rgb_lzw_37x21.tif"],
    "raw: the tile list, the last offset where one tile covers the image":
        ["hw_raw_extra_offsets_reversed_7x5.tif",
         "hw_raw_short_offsets_7x5.tif"],
    "raw: planes by rawmode[layer], an index past it passes the file on":
        ["lt_planar_rgb_raw_37x21.tif", "hw_raw_planar_extra_offsets_7x5.tif"],
    "raw: tiles in file order":
        ["hw_raw_strips_twice_7x5.tif"],
    "raw: a tile wider than the image reads rows at its stride":
        ["hw_raw_tile_wider_than_image_7x5.tif",
         "hw_raw_tile_cut_in_padding_7x5.tif"],
    "raw: a short file is refused":
        ["hw_raw_truncated_7x5.tif", "cut616_pw_rgb_raw_19x13.tif"],
    "raw: RowsPerStrip 0 refused":
        ["hw_rps0_raw_7x5.tif"],
    "raw: a single strip opened by path is mapped at the size open reads":
        ["pw_orient6_l_raw_19x13.tif", "pw_orient8_l_raw_19x13.tif"],
    "raw: Pillow's unpackers (bits, inversion, bit order, RGBa)":
        ["lt_miniswhite2_raw_37x21.tif", "lt_fill2_l_raw_37x21.tif",
         "lt_grey12_raw_37x21.tif", "lt_extra_rgba_assoc_raw_37x21.tif",
         "lt_palette4_raw_37x21.tif"],
    "libtiff: the header's version and BigTIFF offset size":
        ["hw_bad_version_lzw_7x5.tif",
         "hw_bigtiff_bad_offset_size_lzw_7x5.tif"],
    "libtiff: the first of duplicate tags, counts of one":
        ["hw_width_count2_lzw_7x5.tif"],
    "libtiff: PlanarConfiguration 1 or 2, RowsPerStrip above 0":
        ["hw_planar3_lzw_7x5.tif", "hw_rps0_lzw_7x5.tif"],
    "libtiff: short StripOffsets padded with zeros":
        ["hw_short_offsets_packbits_7x5.tif"],
    "libtiff: a missing StripByteCounts estimated for one strip":
        ["hw_missing_bytecounts_lzw_7x5.tif",
         "hw_unknown_type_tag_lzw_estimate_7x5.tif"],
    "libtiff: a zero StripByteCounts of one strip estimated":
        ["hw_zero_bytecount_lzw_7x5.tif"],
    "libtiff: BitsPerSample the same for every sample":
        ["hw_bps_count4_spp3_lzw_7x5.tif"],
    "libtiff: a ColorMap of 3 << bps entries, required below 8 bits":
        ["hw_palette4_short_map_lzw_7x5.tif",
         "hw_palette8_short_map_lzw_7x5.tif"],
    "libtiff: Predictor 2 at 8, 16, 32 bits, 3 on floats, else refused":
        ["hw_pred2_4bit_lzw_7x5.tif", "hw_pred5_lzw_7x5.tif",
         "hw_pred3_int_lzw_7x5.tif", "hw_pred_count2_lzw_7x5.tif"],
    "libtiff: a strip past the end of the file refused":
        ["hw_lzw_count_past_end_7x5.tif"],
    "TiffDecode: a strip size or unpacker row libtiff does not give":
        ["lt_planar_rgbx_lzw_37x21.tif", "hw_rps_huge_lzw_7x5.tif"],
    "TiffDecode: tiles at TIFFTileRowSize, planes by RGBA's bands":
        ["lt_planar_tiles_rgbx_lzw_37x21.tif", "lt_planar_la_lzw_37x21.tif",
         "lt_planar_rgb16_lzw_37x21.tif"],
    "TiffDecode: planar RGBA unpremultiplied unless alpha is unassociated":
        ["lt_planar_rgba_assoc_lzw_37x21.tif",
         "lt_planar_rgba_no_extra_lzw_37x21.tif",
         "lt_planar_rgba_lzw_37x21.tif"],
    "TiffDecode: 16-bit samples in the host's order (I;16N)":
        ["lt_be_i16_lzw_37x21.tif", "lt_be_cmyk16_lzw_37x21.tif"],
    "PackBits: runs discarded at the end, short data refused":
        ["hw_packbits_long_run_7x5.tif", "hw_packbits_long_literal_7x5.tif",
         "hw_packbits_short_7x5.tif", "hw_packbits_run_cut_7x5.tif",
         "hw_packbits_literal_cut_7x5.tif", "hw_packbits_nop_7x5.tif"],
    "LZW: a clear code first, codes in the table, EOI or full output":
        ["hw_lzw_no_clear_7x5.tif", "hw_lzw_short_7x5.tif",
         "hw_lzw_cut_stream_7x5.tif", "hw_lzw_no_eoi_7x5.tif",
         "hw_lzw_long_7x5.tif"],
    "LZW: the code width grows one code early":
        ["pw_rgb_lzw_19x13.tif", "lt_tiles16x16_rgb_lzw_37x21.tif"],
    "LZW: old-style codes, picked by the first chunk":
        ["hw_lzw_old_7x5.tif", "hw_lzw_old_then_new_7x5.tif",
         "hw_lzw_new_then_old_7x5.tif", "hw_lzw_old_pred2_7x5.tif"],
    "LZW: old-style width grows past the width's largest code":
        ["hw_lzw_old_wide_40x20.tif"],
    "deflate: zlib's stream, at least the chunk's bytes":
        ["hw_deflate_short_7x5.tif", "hw_deflate_bad_check_7x5.tif",
         "hw_deflate_raw_stream_7x5.tif", "hw_deflate_long_7x5.tif"],
    "fill order 2 reverses each byte before decoding":
        ["lt_fill2_1bit_lzw_37x21.tif", "lt_fill2_rgb_lzw_37x21.tif",
         "lt_fill2_l_deflate_37x21.tif"],
    "predictor 2: host order first, then sums":
        ["lt_pred2_be_i16_lzw_37x21.tif", "lt_pred2_rgb16_deflate_37x21.tif",
         "lt_pred2_i32_lzw_37x21.tif", "lt_pred2_planar_rgb_lzw_37x21.tif"],
    "predictor 3: byte sums, then byte planes interleaved":
        ["lt_pred3_f32_lzw_37x21.tif", "lt_pred3_be_f32_deflate_37x21.tif"],
    "convert: I, I;16 and F clipped, CMYK, P and PA through the palette":
        ["pw_i_raw_19x13.tif", "pw_i16_lzw_19x13.tif", "pw_f_raw_19x13.tif",
         "pw_cmyk_raw_19x13.tif", "pw_pa_lzw_19x13.tif",
         "hw_palette4_short_map_raw_7x5.tif"],
    "sizes: IFD0 past the 64 KiB prefix":
        ["hw_ifd_after_data_past_prefix_7x5.tif"],
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_cases_equal_jax(rule, monkeypatch):
    for name in RULES[rule]:
        path = os.path.join(corpus.FOLDER, name)
        with monkeypatch.context() as m:
            _no_pil(m)
            assert _port(path, _read(name)) == DIGESTS[name], name


def _routed(head: bytes):
    """The plugin that Pillow's open picks by the file's first bytes."""
    picked = formats.pick(head, prefix=True)
    return picked and picked.name


def test_router_takes_pillows_tiff_prefixes():
    for prefix in tiff.PREFIXES:
        assert _routed(prefix + bytes(12)) == "TIFF"
    for bad in (b"II\x2a\x01", b"MM\x00\x2c", b"II", b"IM\x2a\x00"):
        assert _routed(bad + bytes(12)) is None
    assert _routed(b"P6 2 1 255\n") == "PPM"


def test_only_the_left_tags_reach_pil(tmp_path, monkeypatch):
    """No file the port decodes or refuses is handed to PIL, though PIL
    is importable: only files Pillow's plugin passes on that a plugin
    after it which the port does not read opens (data/formats.py; none in
    the corpus: the port refuses them as Image.open does) and those whose
    tags (a codec not read here) are left; no TIFF codec is left any
    more, so the corpus' fax, ThunderScan and SGILog files, like its
    ZSTD, LZMA and CIELab ones, are no longer among them."""
    handed = []
    monkeypatch.setattr(native, "_decode_other",
                        lambda data: handed.append(data))
    for name in NAMES:
        data = _read(name)
        before = len(handed)
        native.decode_image(data)
        native.decode_image(data, by_path=True)
        reached = len(handed) > before
        try:
            header = tiff.open_tiff(data)
        except tiff.NotTiff:
            after = formats.pick(data)     # the plugins after TIFF
            assert reached == (
                after is not None and after.opened is None and
                not after.refused and
                after.name not in formats.SIGNATURE_FORMATS), name
            continue
        except ValueError:
            assert not reached, name
            continue
        assert reached == (tiff.route(header, data) is None), name
        if reached:
            assert header.compression not in ("zstd", "lzma", "webp",
                                              "tiff_jpeg"), name
            assert header.photometric != 8, name
            assert header.compression not in tiff.DECODED or \
                tiff.libtiff_dir(data).compression not in \
                tiff.DECODED.values(), name


def test_every_unpacker_and_conversion_equals_pillow():
    """Each (mode, rawmode) of OPEN_INFO, the libtiff route's native
    rawmodes and the one-band rawmodes of planar files: present where
    Pillow has it, and its pixels through convert("RGB") equal Pillow's
    Image.frombytes(...).convert("RGB") on random bytes."""
    pairs = set(tiff.OPEN_INFO.values())
    for mode, raw in list(pairs):
        if raw == "I;16" or raw.endswith((";16B", ";16L")):
            pairs.add((mode, "I;16N" if raw == "I;16" else raw[:-1] + "N"))
    for mode in tiff._IMAGE_BANDS:
        for band in "1LIRGBAXaPCMYKF;":
            pairs.add((mode, band))
    rng = np.random.default_rng(0)
    w, h = 37, 5
    for mode, raw in sorted(pairs):
        data = rng.integers(0, 256, 40 * w * h, np.uint8).tobytes()
        try:
            im = Image.frombytes(mode, (w, h), data, "raw", raw)
        except ValueError:
            with pytest.raises(ValueError):
                tiff.rawmode_bits(mode, raw)
            continue
        bits = tiff.rawmode_bits(mode, raw)
        row = (w * bits + 7) // 8
        store = tiff._new(mode, w, h)
        tiff.unpack(mode, raw, np.frombuffer(data, np.uint8, row * h)
                    .reshape(h, row), w, store)
        palette = bytes(rng.integers(0, 256, 3 * 200, np.uint8))
        if mode in ("P", "PA"):
            im.putpalette(palette, "RGB;L")
        np.testing.assert_array_equal(
            convert.to_rgb(mode, store, palette), np.asarray(
                im.convert("RGB")), err_msg=f"{mode} {raw}")


def test_sizes_read_only_ifd0(tmp_path, monkeypatch):
    """read_image_size reads IFD0 where it lies, not the pixel data."""
    name = "hw_ifd_after_data_past_prefix_7x5.tif"
    path = os.path.join(corpus.FOLDER, name)
    assert os.path.getsize(path) > 65536
    read = []
    view = tiff.FileView.__getitem__
    monkeypatch.setattr(tiff.FileView, "__getitem__",
                        lambda self, s: read.append(s) or view(self, s))
    assert native.read_image_size(path) == (80, 300)
    assert all((s.stop or 0) - (s.start or 0) < 4096 for s in read)


def test_threads_decode_alike():
    """The C shares no state; ctypes releases the GIL."""
    datas = [_read(n) for n in NAMES if "_lzw_" in n or "pack" in n] * 2
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
    assert all(_sha(g) == _sha(w) for g, w in zip(got, want))


# -- sweeps -------------------------------------------------------------------

# (spp, bps, photometric, extra samples, sample format): OPEN_INFO's keys
KINDS = [(1, 1, 1, (), 1), (1, 1, 0, (), 1), (1, 2, 1, (), 1),
         (1, 4, 0, (), 1), (1, 8, 1, (), 1), (1, 8, 0, (), 1),
         (1, 8, 1, (), 2), (1, 12, 1, (), 1), (1, 16, 1, (), 1),
         (1, 16, 1, (), 2), (1, 32, 1, (), 1), (1, 32, 1, (), 2),
         (1, 32, 1, (), 3), (2, 8, 1, (2,), 1), (3, 8, 2, (), 1),
         (4, 8, 2, (), 1), (4, 8, 2, (0,), 1), (5, 8, 2, (1, 0), 1),
         (4, 8, 2, (1,), 1), (4, 8, 2, (2,), 1), (3, 16, 2, (), 1),
         (4, 16, 2, (1,), 1), (1, 4, 3, (), 1), (1, 8, 3, (), 1),
         (2, 8, 3, (2,), 1), (4, 8, 5, (), 1), (4, 16, 5, (), 1)]


@st.composite
def libtiff_files(draw):
    """A file from the tests' libtiff writer: any kind of OPEN_INFO, size,
    codec, strips or tiles, planes, predictor, fill order, byte order,
    BigTIFF and Orientation."""
    spp, bps, photo, extra, fmt = draw(st.sampled_from(KINDS))
    h, w = draw(st.integers(1, 33)), draw(st.integers(1, 40))
    rng = np.random.default_rng(draw(st.integers(0, 2 ** 16)))
    if fmt == 3:
        s = (rng.standard_normal((h, w, spp)) * 300).astype(np.float32)
    elif fmt == 2:
        s = rng.integers(-(1 << (bps - 1)), 1 << (bps - 1), (h, w, spp))
    else:
        s = rng.integers(0, 1 << bps, (h, w, spp))
    comp = draw(st.sampled_from([1, 5, 8, 32946, 32773]))
    spec = dict(photometric=photo, compression=comp, sampleformat=fmt,
                extra=extra, planar=draw(st.sampled_from([1, 2])),
                fillorder=draw(st.sampled_from([1, 1, 2])),
                bigendian=draw(st.integers(0, 1)),
                bigtiff=draw(st.integers(0, 1)),
                orientation=draw(st.integers(0, 8)))
    if draw(st.booleans()):
        spec.update(tile_width=16 * draw(st.integers(1, 2)),
                    tile_height=16 * draw(st.integers(1, 2)))
    else:
        spec["rows_per_strip"] = draw(st.integers(1, h + 2))
    if comp in (5, 8, 32946) and draw(st.booleans()):
        spec["predictor"] = 3 if fmt == 3 else 2 if bps in (8, 16, 32) \
            else 1
    cmap = rng.integers(0, 65536, 3 << bps) if photo == 3 else None
    return corpus.libtiff(s, bps, colormap=cmap, **spec)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(data=libtiff_files())
def test_random_libtiff_files_equal_pillow(data, tmp_path_factory):
    path = _write(tmp_path_factory.mktemp("f"), data)
    assert _port_no_pil(path, data) == _jax(path)


@st.composite
def changed_files(draw):
    """A corpus file with one to three bytes changed, mostly in its header
    and directory."""
    names = [n for n in NAMES if not n.startswith(("cut", "hw_left",
                                                   "hw_ifd_after"))]
    data = bytearray(_read(draw(st.sampled_from(names))))
    for _ in range(draw(st.integers(1, 3))):
        at = draw(st.integers(0, min(len(data), 400) - 1))
        data[at] = draw(st.integers(0, 255))
    return bytes(data)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(data=changed_files())
def test_changed_bytes_equal_pillow(data, tmp_path_factory):
    try:                          # both would fill a large image: skip it
        w, h = tiff.open_tiff(data).tile_size
        assume(w * h <= 1 << 16)
    except (tiff.NotTiff, ValueError):
        pass
    path = _write(tmp_path_factory.mktemp("f"), data)
    want = _jax(path)
    got = _port_no_pil(path, data)
    if _left(data):
        assert got["hw"] == want["hw"]
    else:
        assert got == want
