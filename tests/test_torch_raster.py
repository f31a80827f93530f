"""DIB, ICO, CUR, PCX, DCX, MSP, QOI, SGI, SPIDER, TGA, XBM and IM as the
port reads them (data/raster.py, csrc/raster_decode.cc, the DIB entry of
csrc/bmp_decode.cc) and routes them (data/formats.py: Pillow's plugins in
Pillow's open order) against the JAX package's routes, which hand them to
Pillow 12.1.0, on the same bytes, with PIL unimportable for the port.

Every file of the committed corpus (tests/torch_raster_corpus.py) and the
made 640x480 scenes give, bitwise, what each JAX route gives, or fail
where it fails. Also: the committed digests equal the JAX routes here and
the generator remakes the corpus byte for byte; the plugin table is
Pillow's registry in its order, with its accept functions; every file goes
to the plugin Pillow's ``Image.open`` picks (hand-made prefixes that two
plugins accept, headers that IMT, IPTC or PCD open, and the corpus), and
only the files of plugins the port leaves to PIL reach it; the open reads
Pillow's size and mode; for each rule the corpus pins, the files that fail
when the rule is mutated in a copy of the port; and a bounded sweep of
corpus files with changed and cut bytes against Pillow.
"""

import io
import os
import struct
import sys
import tempfile
import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from tests import torch_raster_corpus as corpus
from tests import torch_tiff_corpus as tc
from yolov5m_tpu_torch.data import formats, native

torch.set_num_threads(1)

DIGESTS = corpus.load()
MADE = corpus.made()
NAMES = sorted(n for n in DIGESTS if n not in MADE)
# the files a plugin the port does not read opens: PIL's alone
LEFT = corpus.LEFT_TO_PIL


def _read(name: str) -> bytes:
    if name in MADE:
        return MADE[name]
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


def _path(name: str, tmp: str) -> str:
    if name in MADE:
        return _on_disk(name, MADE[name], tmp)
    return os.path.join(corpus.FOLDER, name)


def _want(name: str) -> dict:
    """The JAX routes' digests; for a file a plugin the port leaves to PIL
    opens, what the port gives with PIL blocked: refused, no size."""
    if name.startswith(LEFT):
        return {"loader": None, "load": None, "img": None, "hw": None}
    return DIGESTS[name]


@pytest.mark.parametrize("name", NAMES)
def test_corpus_file_equals_jax(name, tmp_path):
    assert _port(_path(name, str(tmp_path)), _read(name)) == _want(name)


def test_scenes_equal_jax(tmp_path):
    """The made 640x480 scenes (and the 256x256 ICO) decode on every route
    to Pillow's pixels at Pillow's size, as chip_smoke.py's 9s reads them
    on the card."""
    assert sorted(MADE) == sorted(corpus.SCENES)
    for name in corpus.SCENES:
        want = DIGESTS[name]
        assert want["hw"] == ([256, 256] if "ico" in name else [480, 640])
        assert want["img"], name
        assert _port(_path(name, str(tmp_path)), _read(name)) == want, name


def test_committed_digests_equal_jax_here(tmp_path):
    """The digests chip_smoke.py holds the port to are the JAX routes'
    pixels and sizes on this machine."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name in sorted(DIGESTS):
            assert DIGESTS[name] == tc.reference(
                _path(name, str(tmp_path))), name


def test_corpus_remakes_exactly():
    made = corpus.cases()
    assert sorted(made) == NAMES
    for name, data in made.items():
        assert data == _read(name), name
    files = [n for n in os.listdir(corpus.FOLDER) if n != corpus.DIGESTS]
    assert sorted(files) == NAMES
    total = sum(os.path.getsize(os.path.join(corpus.FOLDER, n))
                for n in os.listdir(corpus.FOLDER))
    assert total < 2_500_000


def test_plugin_table_is_pillows_registry():
    """The table's plugins are Pillow's, in ``Image.ID``'s order (preinit's
    six, then init's), and a plugin has an accept function where Pillow's
    has one."""
    from PIL import Image

    Image.init()
    assert [p.name for p in formats.PLUGINS] == list(Image.ID)
    for p in formats.PLUGINS:
        assert (p.accept is None) == (Image.OPEN[p.name][1] is None), p.name
    assert [p.name for p in formats.PLUGINS if p.accept is None] == [
        "IM", "IMT", "IPTC", "PCD", "SPIDER", "TGA"]


def _prefixes():
    rng = np.random.default_rng(7)
    heads = [bytes(rng.integers(0, 256, 16, np.uint8)) for _ in range(3000)]
    for magic in (b"BM", b"\0\0\1\0", b"\0\0\2\0", b"\n\5", b"\n\0",
                  b"\xb1\x68\xde\x3a", b"DanM", b"LinS", b"qoif", b"\1\xda",
                  b"#define", b"  #define", b"\x28\0\0\0", b"\x0c\0\0\0",
                  b"\x7c\0\0\0", b"ftypavif", b"SIMPLE", b"8BPS", b"icns",
                  b"\x59\xa6\x6a\x95", b"\x89PNG\r\n\x1a\n", b"P6", b"Pf",
                  b"GIF89a", b"\xff\xd8\xff", b"II*\0", b"MM\0*",
                  b"\0\0\0\x0cjP  \r\n\x87\n", b"\xff\x4f\xff\x51",
                  b"\xd7\xcd\xc6\x9a\0\0", b"\1\0\0\0", b"DDS ", b"BLP2",
                  b"\0\0\1\xb3", b"\x80\xe8\0\0", b"/* XPM */", b"P7 332"):
        for k in range(20):
            tail = bytes(rng.integers(0, 256, 16, np.uint8))
            heads.append((magic + tail)[:16])
            heads.append((b"    " + magic + tail)[:16] if k == 0 else
                         (magic + bytes(16))[:16])
    return heads


def test_accept_functions_equal_pillows():
    """Each plugin's accept function against Pillow's own on random
    prefixes and on prefixes that start with every plugin's magic."""
    from PIL import Image

    Image.init()
    for p in formats.PLUGINS:
        accept = Image.OPEN[p.name][1]
        if accept is None:
            continue
        for head in _prefixes():
            try:
                want = accept(head)
            except (IndexError, struct.error):
                want = False
            assert formats._accepts(p, head) == (want is True), \
                (p.name, head)


def _pillow_format(data: bytes):
    from PIL import Image

    try:
        with Image.open(io.BytesIO(data)) as im:
            return im.format
    except Image.UnidentifiedImageError:
        return None
    except Exception:
        return "refused"


def _handmade_routes():
    """Files whose first bytes several plugins may take."""
    tga16 = corpus.tga(corpus.picture(1, 5, 6, 2).astype(np.uint8), 2, 16,
                       0x20)
    files = {
        # CUR's accept takes it, CUR finds no cursors: TGA reads it
        "tga_under_cur": tga16,
        # ICO's accept takes a type 1 TGA without a map, and fails it
        "tga_under_ico": corpus.tga(np.zeros((5, 6, 1), np.uint8), 1, 8,
                                    0x20),
        # a DIB header that is also a TGA header: DIB first
        "dib_tga": corpus.dib(corpus.picture(2, 5, 6), 24),
        # headers that IMT, IPTC and PCD open (no accept function)
        "imt": b"width 4\nheight 3\npixel n8\n\x0c" + bytes(12),
        "imt_bad_number": b"width x4\n\x0c" + bytes(12),
        "iptc": bytes.fromhex("1c033c00020100") + bytes.fromhex(
            "1c03140002") + b"\0\x04" + bytes.fromhex("1c031e0002") +
        b"\0\x03" + bytes.fromhex("1c0378000101") + bytes.fromhex(
            "1c080a0002") + b"\0\0",
        "pcd": bytes(2048) + b"PCD_" + bytes(1535),
        "pcd_short": bytes(2048) + b"PCD_" + bytes(100),
        # garbage that TGA would read as a type 3 image
        "tga_shaped_garbage": bytes((0, 0, 3)) + bytes(9) + bytes(
            (6, 0, 5, 0, 8, 0x20)) + bytes(30),
        # an IM header before a TGA's bytes
        "im_then_tga": b"Image type: Greyscale image\r\n" +
        b"Image size (x*y): 6*5\r\n\x1a" + tga16,
        # a SPIDER header
        "spider": corpus.spider(np.ones((5, 6), np.float32)),
        # a PCX accept on a truncated header
        "pcx_short": b"\n\5\1\x08",
        # MSP with a bad checksum, then a TGA-shaped rest
        "msp_bad": b"DanM" + bytes(28),
        # SUN, GBR, PIXAR, MCIDAS and WMF headers that pass on and open
        "sun_open": struct.pack(">8I", 0x59A66A95, 4, 3, 8, 12, 1, 0, 0) +
        bytes(12),
        "sun_pass": struct.pack(">8I", 0x59A66A95, 4, 3, 7, 12, 1, 0, 0),
        "gbr_open": struct.pack(">5I", 21, 1, 2, 2, 1) + bytes(8),
        "gbr_pass": struct.pack(">5I", 21, 1, 0, 2, 1) + bytes(8),
        "pixar_pass": b"\x80\xe8\0\0" + bytes(508),
        "mcidas_pass": bytes(7) + b"\x04" + bytes(248),
        "wmf_pass": b"\1\0\0\0" + bytes(40),
        "fli_pass": bytes(4) + b"\x11\xaf" + bytes(8) + b"\3\0" + b"x" * 112,
        "psd_pass": b"8BPS\0\2" + bytes(20),
    }
    for name in ("tga_cmap24_flags20_9x7.tga", "spider_big_9x7.spi",
                 "im_pillow_rgb_13x9.im", "xbm_pillow_21x9.xbm"):
        data = _read(name)
        files[f"{name}_cut_header"] = data[:12]
        files[f"{name}_garbage_tail"] = data[:40] + bytes(range(200))
    return files


def test_files_go_where_image_open_puts_them():
    """Hand-made prefixes and the corpus: the plugin the table picks is
    the one Pillow's Image.open picks, the six without an accept function
    among them; a file no plugin opens is picked by none, and a plugin's
    open that fails ends the walk at it."""
    files = dict(_handmade_routes())
    files.update({n: _read(n) for n in NAMES})
    picked_names = set()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, data in sorted(files.items()):
            want = _pillow_format(data)
            got = formats.pick(data)
            if want is None:
                assert got is None, name
            elif want == "refused":
                assert got is not None and (got.refused or
                                            got.opened is None), name
            else:
                assert got is not None and got.name == want, (name, got)
                picked_names.add(want)
    assert {"TGA", "SPIDER", "IM", "IMT", "IPTC", "PCD", "DIB", "CUR", "ICO",
            "PCX", "DCX", "MSP", "QOI", "SGI", "XBM", "SUN",
            "GBR"} <= picked_names


def test_only_left_plugins_reach_pil(monkeypatch, tmp_path):
    """No corpus file the port reads or refuses is handed to PIL, though
    PIL is importable: only those a plugin the port leaves to PIL opens
    (IMT, PCD) reach _decode_other, by their headers alone."""
    handed = []
    monkeypatch.setattr(native, "_decode_other",
                        lambda data: handed.append(bytes(data)))
    for name in NAMES:
        data = _read(name)
        path = _on_disk(name, data, str(tmp_path))
        before = len(handed)
        native.decode_image(data)
        _attempt(native.load_image_pillow, path)
        _attempt(native.load_image_rgb, path)
        assert len(handed) - before == (3 if name.startswith(LEFT) else 0), \
            name


def test_open_equals_pillows_open():
    """The port's open against Pillow's on every corpus file Pillow opens:
    the plugin, the mode and the size."""
    from PIL import Image

    opened = set()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name in NAMES:
            data = _read(name)
            try:
                im = Image.open(io.BytesIO(data))
            except Exception:
                continue
            got = formats.pick(data)
            if got.opened is None:
                continue
            if im.format not in ("ICO", "CUR", "DIB"):
                assert got.opened.mode == im.mode, name
            assert tuple(got.opened.size) == im.size, name
            opened.add(im.format)
    assert opened == {"DIB", "ICO", "CUR", "PCX", "DCX", "MSP", "QOI", "SGI",
                      "SPIDER", "TGA", "XBM", "IM"}


def test_corpus_covers_what_it_claims():
    """Every plugin, the modes the writers emit and the refusals."""
    from PIL import Image

    modes = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name in NAMES:
            try:
                im = Image.open(io.BytesIO(_read(name)))
                modes.setdefault(im.format, set()).add(im.mode)
            except Exception:
                pass
    assert modes["IM"] >= {"1", "L", "LA", "P", "PA", "I", "I;16", "I;16L",
                           "I;16B", "F", "RGB", "RGBA", "CMYK", "YCbCr"}
    assert modes["TGA"] >= {"L", "LA", "P", "RGB", "RGBA"}
    assert modes["SGI"] >= {"L", "RGB", "RGBA"}
    assert modes["PCX"] >= {"1", "L", "P", "RGB"}
    refused = {n for n in NAMES if DIGESTS[n]["img"] is None}
    for name in ("pcx_run_overrun_11x7.pcx", "sgi_rle_overrun_13x9.sgi",
                 "tga_rle_cut_17x11.tga", "qoi_cut_17x14.qoi",
                 "msp_v2_run_cut_29x11.msp", "ico_mask_cut_16x16.ico",
                 "tga_cmap32_flags20_9x7.tga", "im_bits33_13x9.im"):
        assert name in refused, name
    for name in ("sgi_rle_short_count_13x9.sgi",
                 "tga_rle_literals_across_rows_17x11.tga",
                 "im_lut_la_13x9.im", "tga_cmap16_flags00_9x7.tga"):
        assert name not in refused, name


# Each rule of Pillow's that the corpus pins, and the corpus files whose
# routes change when the rule is mutated in a copy of yolov5m_tpu_torch/
# (one mutation a rule).
RULES = {
    "CUR: the largest entry by both sides":
        ["cur_first_largest_8x8.cur"],
    "DCX: the first frame":
        ["dcx_cut_21x13.dcx",
        "dcx_second_first_21x13.dcx",
        "dcx_two_frames_21x13.dcx"],
    "DIB: the pixel data right after the header, masks and palette":
        ["cur_first_largest_8x8.cur",
        "dib_core12_p8_11x9.dib",
        "dib_p4_11x9.dib",
        "dib_pillow_1_19x13.dib",
        "dib_pillow_l_19x13.dib",
        "dib_pillow_p_19x13.dib",
        "ico_dib_1bit_16x16.ico",
        "ico_dib_4bit_16x16.ico"],
    "ICO and CUR: the XOR image is half the DIB's height":
        ["cur_odd_height_12x10.cur",
        "ico_odd_height_16x15.ico"],
    "ICO: a 32-bit entry's alpha bytes must be in the file":
        ["ico_bpp32_entry_8bit_dib_16x16.ico"],
    "ICO: a width or height byte of 0 is 256":
        ["ico_dim_byte0_8x8.ico"],
    "ICO: entries ordered by colour depth before area (both stable)":
        ["ico_same_area_depths_16x16.ico"],
    "ICO: the AND mask's rows padded to 32 bits":
        ["ico_entry_size_small_16x16.ico"],
    "IM: L*n floats packed least significant first":
        ["im_bits5_13x9.im"],
    "IM: RGB3's planes in the order G, R, B":
        ["im_mode_rgbx_after_rgb3_13x9.im",
        "im_rgb3_13x9.im",
        "im_ryb3_13x9.im"],
    "IM: YCbCr through Pillow's YCbCr to RGB":
        ["im_pillow_ycbcr_13x9.im"],
    "IM: a Lut that is not grey makes a P image":
        ["im_lut_colour_13x9.im",
        "im_lut_la_13x9.im",
        "im_pillow_p_13x9.im"],
    "IM: rows bottom up":
        ["im_l_16_13x9.im",
        "im_l_16s_13x9.im",
        "im_l_32_13x9.im",
        "im_l_32_f_13x9.im",
        "im_l_32_s_13x9.im",
        "im_l_8_13x9.im",
        "im_l_8s_13x9.im",
        "im_lut_colour_13x9.im"],
    "MSP v2: a row of length 0 is white":
        ["msp_v2_blank_row_29x11.msp"],
    "MSP v2: a run cut short fails the load":
        ["msp_v2_run_cut_long_row_29x11.msp"],
    "MSP: the checksum of all 16 words":
        ["msp_pillow_v1_29x11.msp",
        "msp_v1_cut_29x11.msp",
        "msp_v2_29x11.msp",
        "msp_v2_blank_row_29x11.msp",
        "msp_v2_long_row_29x11.msp",
        "msp_v2_run_cut_29x11.msp",
        "msp_v2_run_cut_long_row_29x11.msp",
        "msp_v2_runs_40x12.msp"],
    "PCX RLE: a run past the row's buffer fails the load":
        ["pcx_run_overrun_11x7.pcx"],
    "PCX: a row's planes moved together where they are wider than the "
    "unpacker reads them":
        ["dcx_two_frames_21x13.dcx",
        "pcx_1bit_2planes_padded_3x9.pcx",
        "pcx_1bit_4planes_padded_3x9.pcx",
        "pcx_pillow_rgb_21x13.pcx"],
    "PCX: a stride made even where the header's differs":
        ["dcx_cut_21x13.dcx",
        "dcx_second_first_21x13.dcx",
        "dcx_two_frames_21x13.dcx",
        "pcx_1bit_2planes_padded_3x9.pcx",
        "pcx_1bit_4planes_padded_3x9.pcx",
        "pcx_bad_box_0x0.pcx",
        "pcx_cut_21x13.pcx",
        "pcx_l_odd_stride_11x7.pcx"],
    "PCX: by path, a seek before the file's start fails":
        ["pcx_l_odd_stride_11x7.pcx",
        "pcx_literals_11x7.pcx",
        "pcx_run_overrun_11x7.pcx"],
    "PCX: the trailing palette unless it is a grey ramp":
        ["pcx_pillow_p_21x13.pcx"],
    "QOI: an index never set reads 0, 0, 0, 0":
        ["qoi_index_alpha_4x1.qoi"],
    "QOI: the index hash counts alpha":
        ["qoi_ops_rgb_17x14.qoi",
        "qoi_ops_rgba_20x15.qoi",
        "qoi_rgb_ops_channels4_17x14.qoi"],
    "SGI RLE: a chunk count ending on a nonzero atom stops the image":
        ["sgi_rle_short_count_13x9.sgi"],
    "SGI RLE: a length past 2^31 expands nothing":
        ["sgi_rle_length_negative_13x9.sgi"],
    "SGI RLE: a run past the row fails the load":
        ["sgi_rle_overrun_13x9.sgi"],
    "SGI16: the high byte of each sample":
        ["sgi_pillow_l_16bit_13x9.sgi",
        "sgi_pillow_rgb_16bit_13x9.sgi",
        "sgi_pillow_rgba_16bit_13x9.sgi",
        "sgi_rle16_1ch_13x9.sgi",
        "sgi_rle16_3ch_13x9.sgi",
        "sgi_rle16_4ch_13x9.sgi"],
    "SGI: rows bottom up":
        ["sgi_pillow_l_13x9.sgi",
        "sgi_pillow_rgb_13x9.sgi",
        "sgi_pillow_rgba_13x9.sgi"],
    "TGA RLE: a literal runs on into the next rows":
        ["tga_rle_literals_across_rows_17x11.tga"],
    "TGA RLE: a run may not pass the row's end":
        ["tga_rle_run_over_row_17x2.tga"],
    "TGA: 16-bit pixels scaled by 255 / 31":
        ["tga_16bit_flags00_9x7.tga",
        "tga_16bit_flags10_9x7.tga",
        "tga_16bit_flags20_9x7.tga",
        "tga_16bit_flags30_9x7.tga",
        "tga_16bit_rle_flags00_9x7.tga",
        "tga_16bit_rle_flags10_9x7.tga",
        "tga_16bit_rle_flags20_9x7.tga",
        "tga_16bit_rle_flags30_9x7.tga"],
    "TGA: L and LA images convert through a colour map":
        ["tga_grey_cmap24_9x7.tga",
        "tga_la_cmap16_9x7.tga"],
    "TGA: a 32-bit colour map fails the load":
        ["tga_cmap32_flags00_9x7.tga",
        "tga_cmap32_flags10_9x7.tga",
        "tga_cmap32_flags20_9x7.tga",
        "tga_cmap32_flags30_9x7.tga"],
    "TGA: a colour map's first entry skips that many entries":
        ["tga_cmap16_flags00_9x7.tga",
        "tga_cmap16_flags10_9x7.tga",
        "tga_cmap16_flags20_9x7.tga",
        "tga_cmap16_flags30_9x7.tga",
        "tga_cmap24_257_entries_9x7.tga",
        "tga_cmap24_flags00_9x7.tga",
        "tga_cmap24_flags10_9x7.tga",
        "tga_cmap24_flags20_9x7.tga"],
    "TGA: origin bit 4 flips the rows left to right":
        ["tga_16bit_flags10_9x7.tga",
        "tga_16bit_flags30_9x7.tga",
        "tga_16bit_rle_flags10_9x7.tga",
        "tga_16bit_rle_flags30_9x7.tga",
        "tga_cmap16_flags10_9x7.tga",
        "tga_cmap16_flags30_9x7.tga",
        "tga_cmap24_flags10_9x7.tga",
        "tga_cmap24_flags30_9x7.tga"],
    "XBM: bits least significant first":
        ["xbm_crlf_21x9.xbm",
        "xbm_hot_defines_21x9.xbm",
        "xbm_leading_space_21x9.xbm",
        "xbm_pillow_21x9.xbm",
        "xbm_pillow_hotspot_21x9.xbm",
        "xbm_upper_hex_21x9.xbm"],
    "XBM: hex digits in either case":
        ["xbm_upper_hex_21x9.xbm"],
    "routing: CUR passes a file without cursors on":
        ["tga_16bit_flags00_9x7.tga",
        "tga_16bit_flags10_9x7.tga",
        "tga_16bit_flags20_9x7.tga",
        "tga_16bit_flags30_9x7.tga",
        "tga_cur_prefix_9x7.tga",
        "tga_pillow_blocky_rgb_raw_bottom_17x11.tga",
        "tga_pillow_blocky_rgb_raw_top_17x11.tga",
        "tga_pillow_blocky_rgba_raw_bottom_17x11.tga"],
    "routing: IM before TGA and SPIDER":
        ["im_tga_both_6x5.im"],
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_cases_equal_jax(rule, tmp_path):
    assert RULES[rule]
    for name in RULES[rule]:
        assert _port(_path(name, str(tmp_path)), _read(name)) == \
            _want(name), name


@st.composite
def changed_files(draw):
    """A small corpus file with one to four bytes changed or a bit
    flipped (the headers now and then), or cut."""
    name = draw(st.sampled_from([n for n in NAMES if not n.startswith(
        LEFT)]))
    out = bytearray(_read(name))
    kind = draw(st.integers(0, 2))
    if kind == 2:
        return name, bytes(out[:draw(st.integers(0, len(out) - 1))])
    hi = len(out) - 1 if draw(st.booleans()) else min(len(out) - 1, 40)
    for _ in range(draw(st.integers(1, 4)) if kind == 0 else 1):
        at = draw(st.integers(0, hi))
        out[at] = draw(st.integers(0, 255)) if kind == 0 else \
            out[at] ^ (1 << draw(st.integers(0, 7)))
    return name, bytes(out)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(case=changed_files())
def test_changed_bytes_equal_pillow(case):
    """Corpus files with bytes changed or cut: every route equals
    Pillow's, PIL blocked for the port (a file that a plugin the port
    leaves to PIL opens is refused, its size unread)."""
    name, data = case
    with tempfile.TemporaryDirectory() as tmp:
        path = _on_disk(name, data, tmp)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = tc.reference(path)
        got = formats.pick(data)
        if got is not None and not got.refused and got.opened is None and \
                got.name not in formats.SIGNATURE_FORMATS:
            want = {"loader": None, "load": None, "img": None, "hw": None}
        assert _port(path, data) == want
