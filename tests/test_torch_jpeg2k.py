"""JPEG 2000 as the port reads it (data/jpeg2k.py, csrc/j2k_decode.cc)
against the JAX package's routes, which hand it to Pillow 12.1.0's
Jpeg2KImagePlugin over its bundled OpenJPEG 2.5.4, on the same bytes,
with PIL unimportable for the port.

Every file of the committed corpus (tests/torch_jpeg2k_corpus.py) gives,
bitwise, what each JAX route gives, or fails where it fails. Also: the
committed digests equal the JAX routes here and the generator remakes the
corpus byte for byte; every tile of the corpus decodes as the bundled
OpenJPEG's own opj_read_tile_header and opj_decode_tile_data decode it,
driven through ctypes (the stage that fails, each tile's bounds, size and
buffer); Pillow's YCbCr to RGB over all 2^24 pixels; only the files whose
markers name HTJ2K or Part 2's MCT reach PIL, and no other plugin of
Pillow's takes a file the JPEG 2000 plugin accepts; for each rule the
corpus pins, the files that fail when the rule is mutated in a copy of
the port; and a bounded sweep of corpus files with changed and cut bytes
against Pillow.
"""

import ctypes
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

from tests import torch_jpeg2k_corpus as corpus
from tests import torch_tiff_corpus as tc
from yolov5m_tpu_torch.data import jpeg2k, native

torch.set_num_threads(1)

DIGESTS = corpus.load()
NAMES = sorted(DIGESTS)
# the files whose markers name what this slice leaves to others
LEFT = corpus.LEFT_TO_PIL


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


def _want(name: str) -> dict:
    """The JAX routes' digests; for a file left to PIL, what the port
    gives with PIL blocked: refused, with its size read."""
    want = DIGESTS[name]
    if name.startswith(LEFT):
        return {"loader": None, "load": None, "img": None, "hw": want["hw"]}
    return want


@pytest.mark.parametrize("name", NAMES)
def test_corpus_file_equals_jax(name):
    assert _port(os.path.join(corpus.FOLDER, name), _read(name)) == \
        _want(name)


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
    assert total < 2_500_000


def _port_tiles(data: bytes):
    """The port's tile loop with a sink in place of Pillow's checks and
    unpackers: (the stage that failed or None, the tiles as
    openjpeg_tiles gives them)."""
    lib = native.decode_lib()
    cap = 64 << 20
    out = np.zeros(cap, np.uint8)
    info = np.zeros(7 * 4096, np.int64)
    count = ctypes.c_int()
    buf = np.frombuffer(data, np.uint8)
    codec = 0 if data[:4] == jpeg2k.J2K_PREFIX else 2
    rc = lib.j2k_tiles(native._as_u8p(buf), len(data), codec,
                       native._as_u8p(out), cap,
                       info.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                       4096, ctypes.byref(count))
    tiles, at = [], 0
    for k in range(count.value):
        t = [int(v) for v in info[7 * k:7 * k + 7]]
        tiles.append((*t[:6], bool(t[6]), out[at:at + t[5]].tobytes()))
        at += t[5]
    stage = {0: None, 1: "read_header", 2: "read_tile_header",
             3: "decode_tile_data", 4: "end_decompress"}[rc]
    return stage, tiles


def test_tiles_equal_openjpegs_own():
    """The bundled OpenJPEG's own tile loop through ctypes, as Pillow
    calls it, on every corpus file: the same stage fails, and every tile
    has the same index, bounds, data size, result and buffer."""
    seen = 0
    for name in NAMES:
        data = _read(name)
        if name.startswith(LEFT):
            continue
        stage, _, want = corpus.openjpeg_tiles(data)
        got_stage, got = _port_tiles(data)
        assert got_stage == stage, name
        assert len(got) == len(want), name
        for a, b in zip(got, want):
            assert a[:7] == b[:7], (name, a[:7], b[:7])
            if b[6]:
                assert a[7] == b[7], (name, a[0])
        seen += len(want)
    assert seen > 300


def test_ycbcr_to_rgb_equals_pillow():
    """Pillow's YCbCr to RGB (the sYCC unpackers' last step) on every
    (Y, Cb, Cr)."""
    from PIL import Image

    px = np.arange(1 << 24, dtype=np.uint32)
    ycc = np.stack([(px >> 16) & 255, (px >> 8) & 255, px & 255],
                   -1).astype(np.uint8).reshape(4096, 4096, 3)
    want = np.asarray(Image.fromarray(ycc, "YCbCr").convert("RGB"))
    got = np.concatenate([ycc, np.zeros((4096, 4096, 1), np.uint8)], -1)
    native.decode_lib().j2k_ycbcr_rgb(native._as_u8p(got), 1 << 24)
    assert np.array_equal(got[..., :3], want)


def _codestream(data: bytes) -> bytes:
    at = jpeg2k._codestream_at(data, jpeg2k.open_j2k(data))
    return data[at:]


def test_corpus_covers_what_it_claims():
    """Pillow's modes and options, every code-block style bit, SOP, EPH,
    POC, RGN, subsampling, signed components, precisions 1-16, tile-parts,
    PPM and PPT, the five progressions, the JP2 modes CMYK, P and PA, the
    refusals."""
    opened = {}
    styles, progs, precs, signed, markers = set(), set(), set(), set(), set()
    subsampled = 0
    for name in NAMES:
        data = _read(name)
        try:
            h = jpeg2k.open_j2k(data)
        except (jpeg2k.NotJpeg2k, ValueError):
            continue
        opened[name] = h.mode
        cs = _codestream(data)
        if cs[:2] != b"\xff\x4f" or name.startswith("dm_"):
            continue
        for s in corpus.segments(cs):
            if s[0] == 0xFF52:
                styles.add(s[1][12])
                progs.add(s[1][5])
            if s[0] == 0xFF51:
                siz = corpus.siz_of(cs)
                for ssiz, dx, dy in siz["comps"]:
                    precs.add((ssiz & 0x7F) + 1)
                    if ssiz & 0x80:
                        signed.add((ssiz & 0x7F) + 1)
                    subsampled += dx > 1 or dy > 1
            if isinstance(s[0], int):
                markers.add(s[0])
            elif s[0] == "tp":
                markers.update(struct.unpack_from(">H", x)[0] for x in s[2])
                if s[1][9]:
                    markers.add("tile-part index above 0")
        if b"\xff\x91" in cs:
            markers.add(0xFF91)
    assert {1, 2, 4, 8, 16, 32} <= {b for st_ in styles for b in
                                    (1, 2, 4, 8, 16, 32) if st_ & b}
    assert 63 in styles
    assert progs >= {0, 1, 2, 3, 4}
    assert precs >= set(range(1, 17))
    assert signed >= {1, 4, 8, 12, 16}
    assert subsampled >= 10
    assert {0xFF5F, 0xFF5E, 0xFF60, 0xFF61, 0xFF58, 0xFF91,
            "tile-part index above 0"} <= markers
    assert set(opened.values()) >= {"L", "I;16", "LA", "RGB", "RGBA", "CMYK",
                                    "P", "PA"}
    refused = {n for n in NAMES if not DIGESTS[n]["img"]}
    assert {"dm_no_eoc_31x25.j2k", "dm_cut70_31x25.j2k",
            "dm_psot_short_31x25.j2k", "jb_p_257_colours_27x21.jp2",
            "jb_rgb_grey_colr_27x21.jp2", "pp_ppm_split_nppm_35x27.j2k",
            "pp_ppt_zppt_again_35x27.j2k", "pw_rgb_prc16x16_90x70.jp2",
            "mct_part2_41x33.j2k"} <= refused
    for name in ("dm_psot0_31x25.j2k", "dm_eoc_then_bytes_31x25.j2k",
                 "jb_rgb_no_colr_27x21.jp2", "jb_p_9bit_27x21.jp2",
                 "jb_ihdr_nc3_grey_27x21.jp2", "pp_ppt_tileparts_35x27.j2k",
                 "pp_ppm_tileparts_35x27.j2k"):
        assert DIGESTS[name]["img"], name


def test_flagship_scenes_equal_pillow():
    """The 640x480 scenes decode on every route to Pillow's pixels at
    Pillow's size."""
    for name in corpus.SCENES:
        assert DIGESTS[name]["hw"] == [480, 640], name
        assert DIGESTS[name]["img"], name
        assert _port(os.path.join(corpus.FOLDER, name), _read(name)) == \
            DIGESTS[name], name


def test_only_ht_and_mct_reach_pil(monkeypatch):
    """Every corpus file goes to the port's decoder, or is refused, though
    PIL is importable, but for those whose markers name HTJ2K code-blocks
    or Part 2's MCT: those reach _decode_other on every decoding route, by
    their markers (data/jpeg2k.py:route), and give what PIL gives there
    (Pillow's OpenJPEG refuses a COD whose MCT is Part 2's, and these
    code-blocks are not HT-coded: PIL refuses every one)."""
    handed = []
    monkeypatch.setattr(native, "_decode_other",
                        lambda data: handed.append(bytes(data)))
    with tempfile.TemporaryDirectory() as tmp:
        for name in NAMES:
            data = _read(name)
            path = _on_disk(name, data, tmp)
            before = len(handed)
            native.decode_image(data)
            _attempt(native.load_image_pillow, path)
            _attempt(native.load_image_rgb, path)
            _attempt(native.read_image_size, path)
            want = 3 if name.startswith(LEFT) else 0
            assert len(handed) - before == want, name
            if name.startswith(LEFT):
                assert jpeg2k.route(jpeg2k.open_j2k(data), data) is None
    monkeypatch.undo()
    for name in NAMES:
        if name.startswith(LEFT):
            assert corpus.digest(native.decode_image(_read(name))) == \
                DIGESTS[name]["loader"], name


def test_pillows_other_plugins_refuse_a_jpeg2k():
    """Pillow's plugins whose _accept takes a JPEG 2000 prefix: JPEG2000
    alone; every corpus file the JPEG 2000 plugin passes on fails
    Pillow's open, so the port's refusal of it is Pillow's."""
    from PIL import Image

    Image.init()
    accepting = []
    for fmt, (_, accept) in sorted(Image.OPEN.items()):
        if accept is not None and any(accept(p + bytes(28))
                                      for p in jpeg2k.PREFIXES):
            accepting.append(fmt)
    assert accepting == ["JPEG2000"]
    passed_on = 0
    for name in NAMES:
        data = _read(name)
        try:
            jpeg2k.open_j2k(data)
        except jpeg2k.NotJpeg2k:
            passed_on += 1
            with pytest.raises(Image.UnidentifiedImageError):
                Image.open(io.BytesIO(data))
        except ValueError:
            pass
    assert passed_on >= 3


def test_unpackers_equal_pillows():
    """Pillow's choice of unpacker, over every mode ihdr can give (one to
    four components), every colour space colr can name and none, and one
    to four components in the codestream, with and without subsampling,
    and the codestream alone: the port decodes where Pillow does, to
    Pillow's pixels, and refuses where it refuses."""
    seen = decoded = 0
    with tempfile.TemporaryDirectory() as tmp:
        for ncs in range(1, 5):
            for sub in (1, 2) if ncs > 1 else (1,):
                comps = [(1, 1, 8, 0)] + [(sub, sub, 8, 0)] * (ncs - 1)
                planes = [np.arange(64).reshape(8, 8) * 3 % 256] + [
                    np.full((8 // sub, 8 // sub), 60 * i)
                    for i in range(1, ncs)]
                cs = corpus.codestream(planes, comps)
                files = [cs]
                for mode_nc in range(1, 5):
                    for enumcs in (None, 12, 16, 17, 18, 24):
                        files.append(corpus.jp2(cs, [corpus.ihdr(
                            8, 8, mode_nc, 7)] + ([] if enumcs is None else
                                                  [corpus.colr(enumcs)])))
                for k, data in enumerate(files):
                    path = _on_disk(f"m{k}.jp2", data, tmp)
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        want = tc.reference(path)
                    assert _port(path, data) == want, (ncs, sub, k)
                    seen += 1
                    decoded += want["img"] is not None
    assert seen == 175 and 40 < decoded < 130


def test_open_equals_pillows_open():
    """The port's open against Pillow's on every corpus file: the size,
    the mode and, for P and PA, the palette's bytes; the same files
    refused."""
    from PIL import Image

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name in NAMES:
            data = _read(name)
            try:
                im = Image.open(io.BytesIO(data))
            except Exception:
                with pytest.raises((jpeg2k.NotJpeg2k, ValueError)):
                    jpeg2k.open_j2k(data)
                continue
            h = jpeg2k.open_j2k(data)
            assert (h.size, h.mode) == (im.size, im.mode), name
            if im.mode in ("P", "PA"):
                assert h.palette == bytes(im.palette.palette), name


# Each rule of OpenJPEG's and Pillow's that the corpus pins, and the corpus
# files whose routes change when the rule is mutated in a copy of
# yolov5m_tpu_torch/ (one mutation a rule).
RULES = {
    "5/3 tile data: the coefficient halved toward zero":
        ["dm_cod_twice_31x25.j2k",
        "dm_eoc_in_header_31x25.j2k",
        "dm_eoc_then_bytes_31x25.j2k",
        "dm_flip_mid_31x25.j2k",
        "dm_packet_zeroes_31x25.j2k",
        "dm_psot0_31x25.j2k",
        "dm_siz_tile0_31x25.j2k",
        "dm_tile_psot0_31x25.j2k"],
    "5/3: a lone sample at an odd start halved":
        ["ow_odd_1x9.j2k",
        "ow_sub_empty_tiles_42x34.j2k"],
    "9/7 step sizes: no band gain (two_invK stands for it)":
        ["dm_qcd_derived_31x25.j2k",
        "ow_odd_9x1.j2k",
        "ow_offset0_1_41x33.j2k",
        "ow_offset1_1_41x33.j2k",
        "ow_offset3_5_41x33.j2k",
        "ow_offset_tiles_41x33.j2k",
        "ow_rgb_p12_signed_23x19.j2k",
        "ow_rgb_p16_signed_23x19.j2k"],
    "9/7: the high band times two_invK":
        ["dm_qcd_derived_31x25.j2k",
        "ow_odd_9x1.j2k",
        "ow_offset0_1_41x33.j2k",
        "ow_offset1_1_41x33.j2k",
        "ow_offset3_5_41x33.j2k",
        "ow_offset_tiles_41x33.j2k",
        "ow_rgb_p12_signed_23x19.j2k",
        "ow_rgb_p16_signed_23x19.j2k"],
    "BYPASS: raw passes below the fourth coded bit-plane":
        ["ow_style_all_grey_38x45.j2k",
        "ow_style_all_irr_41x33.j2k",
        "ow_style_all_rev_41x33.j2k",
        "ow_style_bypass_grey_38x45.j2k",
        "ow_style_bypass_irr_41x33.j2k",
        "ow_style_bypass_reset_pterm_irr_41x33.j2k",
        "ow_style_bypass_reset_pterm_rev_41x33.j2k",
        "ow_style_bypass_rev_41x33.j2k"],
    "COD: a second one reads over the first":
        ["dm_cod_twice_31x25.j2k"],
    "DC level shift: lrintf rounds half to even":
        ["pw_l_irr_1x40.jp2",
        "pw_l_irr_1x9.jp2",
        "pw_l_irr_40x1.jp2",
        "pw_l_irr_9x1.jp2",
        "scene_ict_640x480.jp2",
        "scene_tiles_640x480.jp2"],
    "EPH: a missing one fails the decode":
        ["dm_eph_missing_31x25.j2k"],
    "ICT: OpenJPEG's constants (1.402, 0.34413, 0.71414, 1.772)":
        ["ow_rgn_irr_41x33.j2k",
        "ow_style_all_irr_41x33.j2k",
        "ow_style_bypass_irr_41x33.j2k",
        "ow_style_bypass_reset_pterm_irr_41x33.j2k",
        "ow_style_bypass_termall_irr_41x33.j2k",
        "ow_style_bypass_vcausal_irr_41x33.j2k",
        "ow_style_pterm_irr_41x33.j2k",
        "ow_style_reset_irr_41x33.j2k"],
    "ImagePalette.getcolor: a colour seen before keeps its index":
        ["jb_p_9bit_27x21.jp2",
        "jb_p_duplicates_27x21.jp2"],
    "JP2: boxes after the codestream read by opj_end_decompress":
        ["jb_box_after_short_len_27x21.jp2"],
    "JP2: the box walk ends quietly where no box header is read (a length "
    "past 2^32 too)":
        ["jb_xl_box_high_27x21.jp2"],
    "JP2: the first colr box kept":
        ["jb_rgb_two_colr_27x21.jp2"],
    "MQ decoder: a 0xFF then a byte above 0x8F feeds ones and stays":
        ["dm_packet_zeroes_31x25.j2k",
        "ow_cprl_sub_42x34.j2k",
        "ow_la_p12_23x19.j2k",
        "ow_precincts_pcrl_sub_42x34.j2k",
        "ow_rgn_irr_41x33.j2k",
        "ow_style_bypass_rev_41x33.j2k",
        "ow_style_bypass_termall_rev_41x33.j2k",
        "ow_style_reset_irr_41x33.j2k"],
    "POC: an order past CPRL yields no packets":
        ["dm_poc_order7_31x25.j2k"],
    "PPM: packet headers from the main header's merged segments":
        ["pp_ppm_35x27.j2k",
        "pp_ppm_35x27.jp2",
        "pp_ppm_one_35x27.j2k",
        "pp_ppm_tileparts_35x27.j2k"],
    "PPT: packet headers from the tile's merged segments":
        ["pp_ppt_35x27.j2k",
        "pp_ppt_tileparts_35x27.j2k"],
    "Pillow's open: CMYK from colr enumcs 12 with 4 components":
        ["jb_cmyk_27x21.jp2"],
    "Pillow's open: a JP2's I;16 from bpc above 8 (precision 10 up)":
        ["ow_grey_p9_23x19.jp2"],
    "Pillow's open: a codestream's I;16 from precision 9 up":
        ["ow_grey_p9_23x19.j2k"],
    "Pillow's open: more than 256 colours refused":
        ["jb_p_257_colours_27x21.jp2"],
    "Pillow's palette: black past its entries":
        ["jb_p_9bit_27x21.jp2",
        "jb_p_duplicates_27x21.jp2",
        "jb_p_one_column_27x21.jp2",
        "jb_p_short_27x21.jp2"],
    "Pillow's pclr: a palette where its widest raw Bi byte is at most 8":
        ["jb_p_9bit_27x21.jp2"],
    "Pillow: RGBA from four grey components as from sRGB":
        ["jb_rgba_grey_colr_27x21.jp2"],
    "Pillow: a shift right rounds (half the dropped range added)":
        ["ow_grey_p9_23x19.jp2",
        "ow_la_p10_23x19.j2k",
        "ow_la_p12_23x19.j2k",
        "ow_la_p16_23x19.j2k",
        "ow_rgb_p10_23x19.jp2",
        "ow_rgb_p12_23x19.jp2",
        "ow_rgb_p12_signed_23x19.j2k",
        "ow_rgb_p16_23x19.jp2"],
    "Pillow: a signed component offset by half its range":
        ["ow_grey_p12_signed_23x19.j2k",
        "ow_grey_p16_signed_23x19.j2k",
        "ow_grey_p1_signed_23x19.j2k",
        "ow_grey_p4_signed_23x19.j2k",
        "ow_grey_p8_signed_23x19.j2k",
        "ow_rgb_p12_signed_23x19.j2k",
        "ow_rgb_p16_signed_23x19.j2k",
        "ow_rgb_p1_signed_23x19.j2k"],
    "Pillow: an unknown colour space guessed as an unspecified one":
        ["jb_rgb_cielab_27x21.jp2",
        "jb_rgb_enumcs_99_27x21.jp2",
        "jb_rgb_icc_27x21.jp2",
        "jb_rgb_no_colr_27x21.jp2"],
    "Pillow: sYCC through its YCbCr to RGB":
        ["jb_rgb_sycc_27x21.jp2",
        "ow_cprl_sub_42x34.j2k",
        "ow_precincts_pcrl_sub_42x34.j2k",
        "ow_sub420_42x34.j2k",
        "ow_sub420_alpha_42x34.j2k",
        "ow_sub420_sycc_42x34.jp2",
        "ow_sub422_42x34.j2k",
        "ow_sub422_sycc_42x34.jp2"],
    "Pillow: subsampled components through the subsampling unpackers alone":
        ["ow_la_subsampled_42x34.j2k"],
    "Pillow: the buffer zeroed for each tile":
        ["ow_poc_tiles_41x33.j2k",
        "ow_sub_empty_tiles_42x34.j2k"],
    "Psot 0: the tile-part runs to the codestream's last 2 bytes":
        ["dm_psot0_31x25.j2k",
        "dm_tile_psot0_31x25.j2k"],
    "RESET: contexts reset after each MQ pass":
        ["ow_style_all_grey_38x45.j2k",
        "ow_style_all_irr_41x33.j2k",
        "ow_style_all_rev_41x33.j2k",
        "ow_style_bypass_reset_pterm_irr_41x33.j2k",
        "ow_style_bypass_reset_pterm_rev_41x33.j2k",
        "ow_style_reset_irr_41x33.j2k",
        "ow_style_reset_rev_41x33.j2k",
        "ow_style_reset_segsym_irr_41x33.j2k"],
    "RGN: the max-shift down of coefficients above the threshold":
        ["ow_rgn20_41x33.j2k",
        "ow_rgn5_41x33.j2k",
        "ow_rgn_irr_41x33.j2k"],
    "SEGSYM: four symbols read after each cleanup pass":
        ["ow_style_reset_segsym_irr_41x33.j2k",
        "ow_style_reset_segsym_rev_41x33.j2k",
        "ow_style_segsym_irr_41x33.j2k",
        "ow_style_segsym_rev_41x33.j2k"],
    "SIZ: the size ihdr gives must be SIZ's":
        ["jb_ihdr_wider_27x21.jp2"],
    "SOP: six bytes skipped where the marker is":
        ["ow_sop_41x33.j2k",
        "ow_sop_eph_41x33.j2k",
        "pp_ppm_35x27.j2k",
        "pp_ppm_35x27.jp2",
        "pp_ppm_one_35x27.j2k",
        "pp_ppm_tileparts_35x27.j2k",
        "pp_ppt_35x27.j2k",
        "pp_ppt_tileparts_35x27.j2k"],
    "SOT: a tile's parts in order from 0":
        ["dm_tile_twice_31x25.j2k"],
    "TERMALL: one pass a segment":
        ["ow_style_all_grey_38x45.j2k",
        "ow_style_all_irr_41x33.j2k",
        "ow_style_all_rev_41x33.j2k",
        "ow_style_bypass_termall_irr_41x33.j2k",
        "ow_style_bypass_termall_rev_41x33.j2k",
        "ow_style_termall_irr_41x33.j2k",
        "ow_style_termall_rev_41x33.j2k"],
    "cleanup: run-length coding of a full stripe's column":
        ["dm_cod_twice_31x25.j2k",
        "dm_eoc_in_header_31x25.j2k",
        "dm_eoc_then_bytes_31x25.j2k",
        "dm_flip_mid_31x25.j2k",
        "dm_packet_zeroes_31x25.j2k",
        "dm_poc_order7_31x25.j2k",
        "dm_psot0_31x25.j2k",
        "dm_qcd_derived_31x25.j2k"],
    "inclusion tag tree: the threshold the layer plus one":
        ["dm_packet_zeroes_31x25.j2k",
        "dm_poc_order7_31x25.j2k",
        "ow_poc_tiles_41x33.j2k",
        "ow_precincts_41x33.j2k",
        "pw_rgb_cprl_90x70.jp2",
        "pw_rgb_layers_90x70.jp2",
        "pw_rgb_layers_irr_90x70.jp2",
        "pw_rgb_lrcp_90x70.jp2"],
    "route: HTJ2K by COD's code-block style bit 0x40":
        ["ht_cod_27x21.j2k",
        "ht_cod_27x21.jp2"],
    "sign context: the xor bit of Table D.3":
        ["dm_cod_twice_31x25.j2k",
        "dm_eoc_in_header_31x25.j2k",
        "dm_eoc_then_bytes_31x25.j2k",
        "dm_flip_mid_31x25.j2k",
        "dm_packet_zeroes_31x25.j2k",
        "dm_poc_order7_31x25.j2k",
        "dm_psot0_31x25.j2k",
        "dm_qcd_derived_31x25.j2k"],
    "strict mode: no EOC after the last tile-part fails":
        ["dm_no_eoc_31x25.j2k",
        "dm_no_eoc_31x25.jp2"],
    "vertically causal: a stripe's last row sees nothing of the next":
        ["ow_style_all_grey_38x45.j2k",
        "ow_style_all_irr_41x33.j2k",
        "ow_style_all_rev_41x33.j2k",
        "ow_style_bypass_vcausal_irr_41x33.j2k",
        "ow_style_bypass_vcausal_rev_41x33.j2k",
        "ow_style_vcausal_grey_38x45.j2k",
        "ow_style_vcausal_irr_41x33.j2k",
        "ow_style_vcausal_rev_41x33.j2k"],
    "zero coding: HL (bandno 1) swaps the horizontal and vertical counts":
        ["dm_cod_twice_31x25.j2k",
        "dm_eoc_in_header_31x25.j2k",
        "dm_eoc_then_bytes_31x25.j2k",
        "dm_flip_mid_31x25.j2k",
        "dm_packet_zeroes_31x25.j2k",
        "dm_poc_order7_31x25.j2k",
        "dm_psot0_31x25.j2k",
        "dm_qcd_guard7_31x25.j2k"],
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_cases_equal_jax(rule):
    assert RULES[rule]
    for name in RULES[rule]:
        assert _port(os.path.join(corpus.FOLDER, name), _read(name)) == \
            _want(name), name


@st.composite
def changed_files(draw):
    """A small corpus file with one to four bytes changed or a bit
    flipped (the headers now and then, the packets mostly), or cut."""
    name = draw(st.sampled_from([n for n in NAMES if not n.startswith(
        ("scene", "pw_rgb_res", *LEFT))]))
    out = bytearray(_read(name))
    kind = draw(st.integers(0, 2))
    if kind == 2:
        return name, bytes(out[:draw(st.integers(0, len(out) - 1))])
    hi = len(out) - 1 if draw(st.booleans()) else min(len(out) - 1, 300)
    for _ in range(draw(st.integers(1, 4)) if kind == 0 else 1):
        at = draw(st.integers(0, hi))
        out[at] = draw(st.integers(0, 255)) if kind == 0 else \
            out[at] ^ (1 << draw(st.integers(0, 7)))
    return name, bytes(out)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(case=changed_files())
def test_changed_bytes_equal_pillow(case):
    """Corpus files with bytes changed or cut: every route equals
    Pillow's, PIL blocked for the port."""
    name, data = case
    with tempfile.TemporaryDirectory() as tmp:
        path = _on_disk(name, data, tmp)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = tc.reference(path)
        if jpeg2k.accepts(data[:16]):
            try:
                if jpeg2k.route(jpeg2k.open_j2k(data), data) is None:
                    want = {"loader": None, "load": None, "img": None,
                            "hw": want["hw"]}
            except (jpeg2k.NotJpeg2k, ValueError):
                pass
        assert _port(path, data) == want
