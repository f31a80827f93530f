"""PNM as the port reads it (data/pnm.py, the plain token scan in
csrc/pnm_decode.cc) against the JAX package's routes, which hand PNM to
Pillow 12.1.0's PpmImagePlugin, on the same bytes, with PIL unimportable
for the port.

Every file of the committed corpus (tests/torch_pnm_corpus.py) gives,
bitwise, what each JAX route gives, or fails where it fails: the server's
``_decode_image`` and the loader's ``load_image_rgb`` (the port's
decode_image and load_image_rgb), detect ``--img``'s ``Image.open(path)
.convert("RGB")`` (load_image_pillow) and the dataset's
``_read_image_size`` (read_image_size); and the port refuses a file where
Pillow refuses it and passes it on where Pillow's PPM plugin passes it on
to the other plugins. The committed digests, which chip_smoke.py holds
the port to on a machine without Pillow, equal the JAX routes here, and
the generator remakes the corpus byte for byte. Also: the header table
of the PPM fault the port had; a hypothesis sweep of headers and one of
plain data across the plain decoder's 1 MiB blocks; every float class,
every CMYK pair and every sample value of several maxvals against
Pillow; for each of Pillow's rules the corpus pins, the cases that fail
when the rule is mutated in the port.
"""

import io
import os
import sys
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from PIL import Image, UnidentifiedImageError

from tests import torch_jpeg_fixtures
from tests import torch_pillow_corpus as pcorpus
from tests import torch_pnm_corpus as corpus
from yolov5m_tpu.data import native as jax_native
from yolov5m_tpu.data.dataset import _read_image_size
from yolov5m_tpu.serving.server import _decode_image
from yolov5m_tpu_torch.data import native, pnm

torch.set_num_threads(1)

DIGESTS = corpus.load()
NAMES = sorted(DIGESTS)
SCENE_DIGESTS = corpus.load(name=corpus.SCENE_DIGESTS)
BOUNDARY = corpus.boundary_cases()


def _scenes() -> dict:
    return corpus.scene_cases(torch_jpeg_fixtures.scene(0))


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


def _pillow_path(path: str):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _jax_routes(path: str, data: bytes) -> dict:
    """What each JAX route gives for a file (None where it fails)."""
    size = _or_none(_read_image_size, path)
    return {"loader": _decode_image(data),
            "load": _or_none(jax_native.load_image_rgb, path),
            "img": _or_none(_pillow_path, path),
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


def _pillow_kind(data: bytes) -> str:
    """"ppm" where Pillow's PPM plugin decodes the file, "refused" where
    Image.open or the load fails there, "passed on" where the plugin
    passes it to the other plugins (none of which reads it here)."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            assert im.format == "PPM", im.format
            im.convert("RGB")
            return "ppm"
    except UnidentifiedImageError:
        return "passed on"
    except (ValueError, OSError, Image.DecompressionBombError):
        return "refused"


def _port_kind(data: bytes) -> str:
    try:
        pnm.decode(data)
        return "ppm"
    except pnm.NotPnm:
        return "passed on"
    except ValueError:
        return "refused"


def _check(path: str, data: bytes, monkeypatch) -> dict:
    want = _jax_routes(path, data)
    with monkeypatch.context() as m:
        _no_pil(m)
        got = _port_routes(path, data)
        kind = _port_kind(data)
    for route in ("loader", "load", "img"):
        assert _same(got[route], want[route]), route
    assert got["hw"] == want["hw"]
    assert kind == _pillow_kind(data)
    return got


def _write(tmp_path, data: bytes, name: str = "f.ppm") -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


@pytest.mark.parametrize("name", NAMES)
def test_corpus_file_equals_jax(name, monkeypatch):
    got = _check(os.path.join(corpus.FOLDER, name), _read(name), monkeypatch)
    if got["img"] is not None:
        assert got["img"].dtype == np.uint8 and \
            got["img"].shape == (*got["hw"], 3)


def test_committed_digests_equal_jax_here():
    """The digests chip_smoke.py holds the port to are the JAX routes'
    pixels on this machine, and the port's."""
    for name in NAMES:
        data = _read(name)
        assert DIGESTS[name] == pcorpus.reference(data), name
        img = native.decode_image(data)
        assert (None if img is None else pcorpus.digest(img)) == \
            DIGESTS[name]["img"], name


def test_corpus_remakes_exactly():
    made = corpus.cases()
    assert sorted(made) == NAMES
    for name, data in made.items():
        assert data == _read(name), name
    files = [n for n in os.listdir(corpus.FOLDER)
             if n not in (corpus.DIGESTS, corpus.SCENE_DIGESTS)]
    assert sorted(files) == NAMES
    assert sum(len(d) for d in made.values()) < 300_000


def test_corpus_covers_what_it_claims():
    """Every magic number, decoder and maxval class is there, refused and
    passed-on files where they are meant to be."""
    headers = {n: pnm.read_header(_read(n)) for n in NAMES
               if _port_kind(_read(n)) != "passed on"
               and not n.startswith("hdr_")}
    assert {h.decoder for h in headers.values()} == {"raw", "ppm",
                                                     "ppm_plain"}
    assert {h.mode for h in headers.values()} == set(pnm.BANDS)
    assert {h.rawmode for h in headers.values()} >= {"1;I", "I;16B",
                                                     "F;32F", "F;32BF"}
    assert {_read(n)[:2] for n in NAMES} >= {
        b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"Pf", b"P0", b"Py"}
    passed = {n for n in NAMES if _port_kind(_read(n)) == "passed on"}
    assert passed == {
        "hdr_magic_comment_2x1.ppm", "hdr_magic_no_space_2x1.ppm",
        "hdr_magic_pf_upper_2x1.pfm", "hdr_magic_p7_2x1.pam",
        "hdr_magic_py_2x1.ppm", "hdr_width0_0x1.ppm",
        "hdr_height_negative_2x-1.ppm", "hdr_comment_crlf_2x0.ppm"}
    for name in NAMES:
        assert DIGESTS[name]["loader"] == DIGESTS[name]["img"], name
    # open succeeds (so the size reads) but the pixels do not decode
    sized = {n for n in NAMES if DIGESTS[n]["hw"] and not DIGESTS[n]["img"]}
    assert {n for n in sized if not n.startswith("cut_")} == {
        "hdr_eof_after_maxval_2x1.ppm", "hdr_under_bomb_10000x10000.pgm",
        "p1_bad_byte_3x1.pbm",
        "p1_bad_after_end_3x1.pbm", "p1_short_3x1.pbm",
        "p2_above_maxval_2x1.pgm", "p2_negative_2x1.pgm",
        "p2_token_11_bytes_2x1.pgm", "p2_junk_token_2x1.pgm",
        "p2_short_3x1.pgm"}


@pytest.mark.parametrize("name", sorted(SCENE_DIGESTS))
def test_scene_equals_committed_digests(name, tmp_path, monkeypatch):
    """The 640x480 scenes chip_smoke.py remakes on the card: the digests
    it holds them to are Pillow's, and the port's."""
    data = _scenes()[name]
    want = SCENE_DIGESTS[name]
    assert pcorpus.pillow_size(data) == want["hw"]
    assert pcorpus.digest(pcorpus.pillow_decode(data)) == want["img"]
    path = _write(tmp_path, data)
    with monkeypatch.context() as m:
        _no_pil(m)
        got = _port_routes(path, data)
    for route in ("loader", "load", "img"):
        assert pcorpus.digest(got[route]) == want["img"], route
    assert got["hw"] == want["hw"]


def test_scene_twins_are_the_p6_scene():
    """P6 at maxval 1000 and plain P3 decode to the P6 scene; the 16-bit
    P5 and the Pf to its grey."""
    got = {n: pnm.decode(d) for n, d in _scenes().items()}
    rgb = got["scene_p6_640x480.ppm"]
    for name in ("scene_p6_maxval1000_640x480.ppm", "scene_p3_640x480.ppm"):
        np.testing.assert_array_equal(got[name], rgb)
    grey = rgb.astype(np.int64).sum(-1) // 3
    for name in ("scene_p5_16bit_640x480.pgm", "scene_pf_640x480.pfm"):
        np.testing.assert_array_equal(got[name][..., 0], grey)


# the fault: (bytes, what Pillow gives); the port read the first three and
# refused the rest
FAULT_TABLE = {
    "magic runs to whitespace": (b"P6#x\n2 1 255\n" + bytes(6), "passed on"),
    "no whitespace after the magic": (b"P62 1 255\n" + bytes(6),
                                      "passed on"),
    "token of 11 bytes": (b"P6 00000000002 1 255\n" + bytes(6), "refused"),
    "comment inside a token": (b"P6 2#c\n0 1 255\n" + bytes(range(60)),
                               (1, 20)),
    "int's sign": (b"P6 +2 1 255\n" + bytes(range(1, 7)), (1, 2)),
    "P5": (b"P5 2 1 255\n\x01\x02", [1, 1, 1, 2, 2, 2]),
    "P3": (b"P3 1 1 255\n1 2 3\n", [1, 2, 3]),
    "maxval 100": (b"P6 1 1 100\n\x01\x02\x03", [3, 5, 8]),
}


@pytest.mark.parametrize("row", sorted(FAULT_TABLE))
def test_ppm_header_fault_is_fixed(row, tmp_path, monkeypatch):
    data, want = FAULT_TABLE[row]
    path = _write(tmp_path, data)
    pillow = pcorpus.pillow_decode(data)
    with monkeypatch.context() as m:
        _no_pil(m)
        got = _port_routes(path, data)
        kind = _port_kind(data)
    if isinstance(want, str):
        assert pillow is None and kind == want
        assert all(v is None for v in got.values())
        return
    assert kind == "ppm"
    for route in ("loader", "load", "img"):
        np.testing.assert_array_equal(got[route], pillow)
    if isinstance(want, tuple):
        assert got["img"].shape[:2] == want
    else:
        assert got["img"].ravel().tolist() == want


@pytest.mark.parametrize("name", sorted(BOUNDARY))
def test_block_boundary_case_equals_jax(name, tmp_path, monkeypatch):
    _check(_write(tmp_path, BOUNDARY[name]), BOUNDARY[name], monkeypatch)


# each rule of Pillow's plugin, its plain decoder and convert("RGB") the
# port follows, with corpus files (or block-boundary cases) that fail when
# the rule is mutated in a copy of data/pnm.py or csrc/pnm_decode.cc
RULES = {
    "magic: read up to whitespace, at most 6 bytes":
        ["hdr_magic_comment_2x1.ppm", "hdr_magic_no_space_2x1.ppm",
         "hdr_magic_6_bytes_2x1.ppm"],
    "magic: MODES exactly (no PF, no Py)":
        ["hdr_magic_pf_upper_2x1.pfm", "hdr_magic_py_2x1.ppm"],
    "tokens: a comment inside a token, and the token goes on":
        ["hdr_comment_in_token_20x1.ppm",
         "hdr_comment_after_maxval_3x1.pgm"],
    "tokens: a comment runs to CR or LF":
        ["hdr_comment_cr_2x1.ppm", "hdr_comment_crlf_2x0.ppm"],
    "tokens: at most 10 bytes":
        ["hdr_token_11_bytes_2x1.ppm", "hdr_token_10_bytes_2x1.ppm"],
    "tokens: every whitespace byte of Pillow's b_whitespace":
        ["hdr_vt_ff_2x1.ppm", "hdr_data_after_cr_3x1.pgm"],
    "tokens: Python's int (sign, underscores)":
        ["hdr_plus_width_2x1.ppm", "hdr_underscore_20x1.ppm",
         "hdr_maxval_plus_2x1.ppm"],
    "open: a width or height below 1 passes the file on":
        ["hdr_width0_0x1.ppm", "hdr_height_negative_2x-1.ppm"],
    "open: 0 < maxval < 65536":
        ["hdr_maxval65536_2x1.ppm", "hdr_maxval0_2x1.ppm"],
    "open: Pf's scale finite and not 0":
        ["hdr_pf_scale0_2x1.pfm", "hdr_pf_scale_nan_2x1.pfm",
         "hdr_pf_scale_inf_2x1.pfm"],
    "open: the decompression-bomb limit":
        ["hdr_bomb_20000x20000.pgm"],
    "data starts after the byte that ended the last token":
        ["hdr_comment_after_maxval_space_3x1.pgm", "p5_maxval255_13x9.pgm"],
    "grey above maxval 255 is mode I, clipped to 255 in RGB":
        ["p2_maxval300_13x9.pgm", "p5_maxval1000_13x9.pgm",
         "pillow_p5_i16_37x23.pgm"],
    "ppm decoder: 2 big-endian bytes a sample from maxval 256":
        ["p5_maxval256_13x9.pgm", "p6_maxval256_13x9.ppm"],
    "scaling: round half to even of v / maxval * out_max":
        ["p5_maxval6_13x9.pgm", "p6_maxval6_13x9.ppm",
         "p2_maxval6_13x9.pgm"],
    "ppm decoder: samples above maxval clip":
        ["p6_above_maxval100_13x9.ppm", "p5_above_maxval6_13x9.pgm",
         "p6_above_maxval1000_13x9.ppm"],
    "P4: bits inverted, rows padded to a byte":
        ["p4_19x7.pbm", "pillow_p4_37x23.pbm", "p4_16x3.pbm"],
    "Pf: a negative scale is little-endian":
        ["pf_le_16x5.pfm", "pf_be_16x5.pfm", "pillow_pf_37x23.pfm"],
    "Pf: rows bottom to top":
        ["pf_le_16x5.pfm", "pillow_pf_37x23.pfm"],
    "F to RGB: clip, truncate toward zero, NaN 0":
        ["pf_le_16x5.pfm", "pf_be_scale2.5_16x5.pfm"],
    "CMYK to RGB: 255 - k less MULDIV255(c, 255 - k)":
        ["p0cmyk_11x6.ppm", "pycmyk_11x6.ppm",
         "p0cmyk_maxval1000_11x6.ppm"],
    "RGBA drops alpha, P has no palette":
        ["pyrgba_11x6.ppm", "pyp_11x6.ppm", "pyrgba_maxval100_11x6.ppm"],
    "raw decoder: a short file is refused, trailing bytes ignored":
        ["cut_p6_maxval255_13x9.ppm", "cut_p4_19x7.pbm",
         "cut_p5_maxval65535_13x9.pgm", "trailing_p6_maxval255_13x9.ppm"],
    "ppm decoder: a short file is refused, trailing bytes ignored":
        ["cut_p6_maxval1000_13x9.ppm", "trailing_p5_maxval1000_13x9.pgm"],
    "plain: a comment in the data joins its neighbours":
        ["p2_comment_joins_2x1.pgm", "p2_comment_cr_joins_2x1.pgm",
         "bnd_comment_across_3x1.pgm"],
    "plain: a comment spans whole blocks":
        ["bnd_comment_spans_block_3x1.pgm"],
    "plain: _find_comment_end's later line end at a block's first byte":
        ["bnd_lf_first_3x1.pgm", "bnd_cr_first_3x1.pgm"],
    "plain: a block's last token carries over to the next block":
        ["bnd_half_token_3x1.pgm"],
    "plain: a carried-over token over 10 bytes is refused":
        ["bnd_long_half_token_3x1.pgm", "bnd_half_token_10_bytes_3x1.pgm"],
    "plain: a data token over 10 bytes is refused":
        ["p2_token_11_bytes_2x1.pgm", "p2_token_10_bytes_2x1.pgm"],
    "plain: negative and above maxval refused, int's sign read":
        ["p2_negative_2x1.pgm", "p2_above_maxval_2x1.pgm",
         "p2_plus_underscore_2x1.pgm", "p2_minus_zero_2x1.pgm"],
    "plain: tokens past the image's end are not read":
        ["p2_junk_after_end_2x1.pgm"],
    "plain: the last token is flushed at the end of the file":
        ["p3_cut_in_last_token_1x1.ppm", "p3_no_final_space_1x1.ppm"],
    "plain: short data is refused":
        ["p2_short_3x1.pgm"],
    "P1: only 0 and 1, every byte of a block read, 0 white":
        ["p1_bad_after_end_3x1.pbm", "bnd_p1_bad_same_block_3x1.pbm",
         "p1_19x7.pbm"],
    "P1: a block past the image's end is not read":
        ["bnd_p1_bad_next_block_3x1.pbm"],
    "sizes: a header past the 64 KiB prefix is read from the whole file":
        ["hdr_long_comment_3x2.pgm", "hdr_p4_height_at_prefix_end_3x12.pbm"],
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_cases_equal_jax(rule, tmp_path, monkeypatch):
    for name in RULES[rule]:
        if name in BOUNDARY:
            data, path = BOUNDARY[name], _write(tmp_path, BOUNDARY[name])
        else:
            data, path = _read(name), os.path.join(corpus.FOLDER, name)
        _check(path, data, monkeypatch)


def test_router_takes_pillows_ppm_prefixes():
    """P and one of 0123456fy, as Pillow's _accept; the other formats'
    signatures still select their decoders."""
    for c in b"0123456fy":
        assert native._pillow_format(b"P" + bytes([c]) + bytes(8)) == "pnm"
    for bad in (b"P7 2 1 255\n", b"PF 2 1\n", b"P", b"p6 2 1 255\n",
                b"Px"):
        assert native._pillow_format(bad) is None
    for fmt, head in (("png", b"\x89PNG\r\n\x1a\n" + bytes(8)),
                      ("jpeg", b"\xff\xd8\xff\xe0" + bytes(12)),
                      ("bmp", b"BM" + bytes(14)),
                      ("gif", b"GIF89a" + bytes(10))):
        assert native._pillow_format(head) == fmt


def test_refused_pnm_never_reaches_pil(tmp_path, monkeypatch):
    """A file Pillow's PPM plugin claims is never handed on, though PIL is
    importable; one it passes on goes to PIL, as Pillow's other plugins."""
    handed = []
    monkeypatch.setattr(native, "_decode_other",
                        lambda data: handed.append(data))
    for name in ("cut_p6_maxval255_13x9.ppm", "p2_negative_2x1.pgm",
                 "hdr_token_11_bytes_2x1.ppm"):
        assert native.decode_image(_read(name)) is None
        with pytest.raises(ValueError, match="cannot decode"):
            native.load_image_pillow(os.path.join(corpus.FOLDER, name))
    assert not handed
    native.decode_image(_read("hdr_magic_no_space_2x1.ppm"))
    assert handed == [_read("hdr_magic_no_space_2x1.ppm")]


def test_decode_ppm_and_encode_ppm_keep_their_results():
    img = np.random.default_rng(4).integers(0, 256, (30, 70, 3), np.uint8)
    ppm = native.encode_ppm(img)
    got = native.decode_ppm(ppm)
    np.testing.assert_array_equal(got, img)
    assert not got.flags.writeable            # a view of the bytes
    assert native.decode_ppm(ppm[:-1]) is None
    assert native.decode_ppm(b"P62 1 255\n" + bytes(6)) is None
    np.testing.assert_array_equal(
        native.decode_ppm(b"P5 2 1 255\n\x01\x02"),
        [[[1, 1, 1], [2, 2, 2]]])


def test_float_bits_convert_as_pillow():
    """Pf at random float32 bit patterns, NaNs and infinities among them."""
    rng = np.random.default_rng(7)
    f = np.concatenate([
        rng.integers(0, 2 ** 32, 2048, np.uint64).astype(np.uint32).view(
            np.float32),
        (rng.standard_normal(2048) * 200).astype(np.float32)]).reshape(64, 64)
    for scale in (b"-1.0", b"3"):
        data = corpus.pfm(f, scale)
        np.testing.assert_array_equal(pnm.decode(data),
                                      pcorpus.pillow_decode(data))


def test_every_cmyk_pair_converts_as_pillow():
    c, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    px = np.stack([c, 255 - c, c // 2, k], -1).astype(np.uint8)
    data = corpus.header(b"P0CMYK", 256, 256, 255) + px.tobytes()
    np.testing.assert_array_equal(pnm.decode(data),
                                  pcorpus.pillow_decode(data))


@pytest.mark.parametrize("maxval", [3, 7, 254, 257, 1023, 65534])
def test_every_sample_value_scales_as_pillow(maxval):
    """Every value a P5 can hold (clipped above maxval) through the ppm
    decoder, and every value to maxval through the plain one."""
    count = 256 if maxval < 256 else 65536
    values = np.arange(count).reshape(-1, 256)
    for data in (corpus.header(b"P5", 256, values.shape[0], maxval) +
                 corpus.binary(values, maxval),
                 corpus.header(b"P2", maxval + 1, 1, maxval) +
                 corpus.plain(np.arange(maxval + 1))):
        np.testing.assert_array_equal(pnm.decode(data),
                                      pcorpus.pillow_decode(data))


def test_threads_decode_alike():
    """The C scan shares no state; ctypes releases the GIL."""
    datas = [_read(n) for n in NAMES if n.startswith(("p2_", "p3_"))] * 2
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


# -- sweeps -------------------------------------------------------------------

_SPACE = st.sampled_from([b" ", b"\t", b"\n", b"\x0b", b"\x0c", b"\r"])
_COMMENT = st.sampled_from([b"", b"", b"", b"#c\n", b"#c\r", b"#\r\n",
                            b"#x"])


@st.composite
def _token(draw, value):
    s = b"%d" % value
    form = draw(st.integers(0, 9))
    if form == 1:
        s = b"+" + s
    elif form == 2:
        s = b"-" + s
    elif form == 3 and len(s) > 1:
        s = s[:1] + b"_" + s[1:]
    elif form == 4:
        s = b"0" * draw(st.integers(1, 9)) + s
    elif form == 5 and len(s) > 1:
        cut = draw(st.integers(1, len(s) - 1))
        s = s[:cut] + draw(_COMMENT) + s[cut:]
    elif form == 6:
        s += draw(st.sampled_from([b"x", b".", b"e1"]))
    return s


@st.composite
def pnm_files(draw):
    """A PNM header of any magic Pillow's _accept takes (and some it
    refuses), with Pillow's separators, comments and int forms, then data
    of the right size give or take a cut or a tail."""
    magic = draw(st.sampled_from(sorted(pnm.MODES) + [b"PF", b"P7", b"Py",
                                                      b"P6x", b"P"]))
    mode = pnm.MODES.get(magic, "RGB")
    w, h = draw(st.integers(-1, 5)), draw(st.integers(-1, 5))
    maxval = draw(st.sampled_from([0, 1, 6, 100, 255, 256, 1000, 65535,
                                   65536]))
    sep = lambda: draw(st.lists(_SPACE, min_size=0, max_size=2).map(
        b"".join)) + draw(_COMMENT)
    head = magic + draw(_SPACE) + sep() + draw(_token(w)) + draw(_SPACE) + \
        sep() + draw(_token(h))
    if magic == b"Pf":
        head += draw(_SPACE) + draw(st.sampled_from(
            [b"-1.0", b"1", b"0", b"nan", b"-inf", b"1_0", b"+2.", b"-1e0"]))
    elif mode != "1":
        head += draw(_SPACE) + sep() + draw(_token(maxval))
    head += draw(st.sampled_from([b"\n", b" ", b"\r\n", b"#x\n", b"",
                                  b"\n\n"]))
    n = max(w, 1) * max(h, 1) * pnm.BANDS[mode]
    seed = draw(st.integers(0, 2 ** 16))
    rng = np.random.default_rng(seed)
    if magic == b"P1":
        body = draw(st.sampled_from([b" ", b"", b"\n"])).join(
            rng.choice([b"0", b"1"], n).tolist())
    elif magic in (b"P2", b"P3"):
        body = corpus.plain(rng.integers(0, max(maxval, 1) + 2, n))
    elif magic == b"P4":
        body = rng.integers(0, 256, (max(w, 1) + 7) // 8 * max(h, 1),
                            np.uint8).tobytes()
    elif magic == b"Pf":
        body = rng.standard_normal(n).astype(np.float32).tobytes()
    else:
        body = rng.integers(0, 256, n * (2 if maxval >= 256 else 1),
                            np.uint8).tobytes()
    data = head + body
    end = draw(st.sampled_from(["whole", "cut", "tail"]))
    if end == "cut":
        data = data[:draw(st.integers(0, len(data)))]
    elif end == "tail":
        data += b" 7 8 9\n"
    return data


@settings(max_examples=200, deadline=None, derandomize=True)
@given(data=pnm_files())
def test_random_headers_equal_pillow(data, tmp_path_factory):
    """decode_image, load_image_pillow and read_image_size with PIL
    blocked, against Pillow on the same bytes: no difference."""
    path = _write(tmp_path_factory.mktemp("f"), data)
    want = _jax_routes(path, data)
    saved = {k: sys.modules.get(k) for k in ("PIL", "PIL.Image")}
    sys.modules.update({"PIL": None, "PIL.Image": None})
    try:
        got = _port_routes(path, data)
        kind = _port_kind(data)
    finally:
        sys.modules.update(saved)
    for route in ("loader", "load", "img"):
        assert _same(got[route], want[route]), route
    assert got["hw"] == want["hw"]
    if native._pillow_format(data) == "pnm":
        assert kind == _pillow_kind(data)


_PIECES = st.sampled_from([b"7", b"12", b"65535", b" ", b"\n", b"\r",
                           b"\r\n", b"#c\n", b"#c\r", b"#", b"\t", b"0",
                           b"00000", b"x", b"+3"])


@st.composite
def boundary_files(draw):
    """A plain P2 or P1 whose first 1 MiB block ends inside a run of
    tokens, comments and line ends."""
    bitonal = draw(st.booleans())
    head = b"P1 4 1\n" if bitonal else b"P2 4 1 65535\n"
    tail = b"".join(draw(st.lists(_PIECES, min_size=4, max_size=16)))
    before = draw(st.integers(0, len(tail)))
    fill = corpus.SAFEBLOCK - before - 2
    rest = draw(st.sampled_from([b"", b" 1 1 1 1\n", b"1 0 1 1 1"]))
    return head + b"#" + b"f" * fill + b"\n" + tail + rest


@settings(max_examples=30, deadline=None, derandomize=True)
@given(data=boundary_files())
def test_random_block_boundaries_equal_pillow(data):
    assert _same(native.decode_image(data), pcorpus.pillow_decode(data))
    assert _port_kind(data) == _pillow_kind(data)
