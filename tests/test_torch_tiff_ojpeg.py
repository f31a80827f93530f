"""12-bit JPEG TIFF and old-style JPEG TIFF as the port reads them
(data/tiff.py; csrc/jpeg_decode.cc: mode 2 at precision 12, the OJpeg
class) against the JAX package's routes, which hand TIFF to Pillow
12.1.0's TiffImagePlugin over its bundled libtiff 4.7.1 (tif_jpeg.c's
12-bit branch over libjpeg-turbo 3.1.3's jpeg12 API; tif_ojpeg.c, then
TIFFRGBAImage for YCbCr), on the same bytes, with PIL unimportable for the
port.

Every file of the committed corpus (tests/torch_tiff_ojpeg_corpus.py),
the 640x480 scenes among them, gives bitwise what each JAX route gives,
or fails where it fails: the server's ``_decode_image`` on the bytes, the
loader's ``load_image_rgb`` and detect ``--img``'s
``Image.open(path).convert("RGB")`` on the path, and the dataset's
``_read_image_size``. Also: the committed digests equal the JAX routes
here and the generator remakes the corpus byte for byte; the 12-bit
samples before convert("RGB") clips them equal Pillow's ``I;16``; no
12-bit or old-style JPEG file reaches PIL; the JPEG decoder's modes 0 and
1 still refuse 12-bit JPEG files, as Pillow's JPEG plugin does; for each
rule the corpus pins, the files that fail when the rule is mutated in a
copy of the port; bounded sweeps of bytes changed in the corpus' files
and of files made at random.
"""

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
from tests import torch_tiff_jpeg_corpus as tj
from tests import torch_tiff_ojpeg_corpus as corpus
from yolov5m_tpu_torch.data import native, tiff

torch.set_num_threads(1)
logging.getLogger("PIL").setLevel(logging.CRITICAL)

DIGESTS = corpus.load()
NAMES = sorted(DIGESTS)
SCENE_NAMES = (*corpus.SCENES, corpus.ROTATED)


def _read(name: str) -> bytes:
    with open(os.path.join(corpus.FOLDER, name), "rb") as f:
        return f.read()


def _attempt(call, *args):
    try:
        return call(*args)
    except ValueError:
        return None


def _without_pil(call, *args):
    saved = {k: sys.modules.get(k) for k in ("PIL", "PIL.Image")}
    sys.modules.update({"PIL": None, "PIL.Image": None})
    try:
        return call(*args)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def _port(path: str, data: bytes) -> dict:
    """Each of the port's routes with PIL unimportable."""
    def routes():
        hw = _attempt(native.read_image_size, path)
        return {"loader": corpus.digest(native.decode_image(data)),
                "load": corpus.digest(_attempt(native.load_image_rgb, path)),
                "img": corpus.digest(_attempt(native.load_image_pillow,
                                              path)),
                "hw": None if hw is None else list(hw)}
    return _without_pil(routes)


def _jax(path: str) -> dict:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return tc.reference(path)


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
    files = [n for n in os.listdir(corpus.FOLDER) if n != corpus.DIGESTS]
    assert sorted(files) == NAMES
    assert sum(len(d) for d in made.values()) < 2_000_000


def test_corpus_covers_what_it_claims():
    """12-bit JPEG in strips and tiles, progressive, arithmetic and
    lossless; old-style JPEG at every subsampling libjpeg takes, through
    JPEGInterchangeFormat and from tables, grey, tiled and planar, decoded;
    refusals of both."""
    decoded = {n for n in NAMES if DIGESTS[n]["img"]}
    kinds = set()
    for name in decoded:
        ldir = tiff.libtiff_dir(_read(name))
        kinds.add((ldir.compression, ldir.bps, ldir.photometric, ldir.planar,
                   ldir.subsampling if ldir.photometric == 6 else None,
                   ldir.tiled))
    assert {(7, 12, 1, 1, None, False), (7, 12, 1, 1, None, True)} <= kinds
    assert {s for c, b, p, pl, s, t in kinds if c == 6 and p == 6} >= {
        (1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2)}
    assert {(p, pl, t) for c, b, p, pl, s, t in kinds if c == 6} >= {
        (6, 1, False), (6, 1, True), (6, 2, False), (1, 1, False)}
    for prefix in ("hm12_progressive", "hm12_arith", "hm12_lossless_p",
                   "oj_jif_", "oj_tables_", "oj_whole_", "oj_strip0_header",
                   "oj_tiled", "oj_planar"):
        assert any(n.startswith(prefix) for n in decoded), prefix
    refused = [n for n in NAMES if DIGESTS[n]["hw"] and
               not DIGESTS[n]["img"]]
    assert len(refused) >= 20
    for name in SCENE_NAMES:
        assert name in decoded
        assert DIGESTS[name]["hw"] in ([480, 640], [640, 480])


def test_scenes_are_flagship_size():
    """The scenes phase 9o reads are 640x480 (480x640 under Orientation
    6), one of each kind, and decode to the scene's pixels' size."""
    for name in SCENE_NAMES:
        img = _without_pil(native.decode_image, _read(name))
        want = (640, 480, 3) if name == corpus.ROTATED else (480, 640, 3)
        assert img.shape == want, name
    kinds = {tiff.libtiff_dir(_read(n)).compression for n in corpus.SCENES}
    assert kinds == {6, 7}


def test_12bit_samples_equal_pillow():
    """Before convert("RGB") clips them at 255: the port's 12-bit samples
    (Pillow's I;16 storage) equal Pillow's own, on every 12-bit file either
    decodes."""
    from PIL import Image

    checked = 0
    for name in NAMES:
        if not name.startswith(("lw12", "hm12", "scene_j12")) or \
                not DIGESTS[name]["img"]:
            continue
        data = _read(name)
        with Image.open(io.BytesIO(data)) as im:
            want = np.asarray(im)
        header = tiff.open_tiff(data)
        got = tiff._load_libtiff(data, header)
        if header.orientation in tiff.TRANSPOSE:  # Pillow's load turns it
            got = tiff._transpose(got, tiff.TRANSPOSE[header.orientation])
        np.testing.assert_array_equal(got, want, err_msg=name)
        checked += 1
    assert checked >= 30


def test_odd_width_12bit_equals_pillow_but_its_last_column():
    """libtiff packs pairs of 12-bit samples: at an odd width a row's last
    sample is never written, and Pillow reads it from a buffer it never
    initialised. Every other column equals Pillow's."""
    from PIL import Image

    for seed, (h, w) in enumerate(((13, 19), (29, 37), (8, 1))):
        data = corpus.tiff12(corpus.dark12(seed, h, w), 8)
        with Image.open(io.BytesIO(data)) as im:
            want = np.asarray(im)
        got = tiff._load_libtiff(data, tiff.open_tiff(data))
        np.testing.assert_array_equal(got[:, :-1], want[:, :-1])


def test_modes_0_and_1_refuse_12bit_jpeg_files(tmp_path):
    """A 12-bit JPEG file: libjpeg-turbo 2.1 (mode 0) and Pillow's JPEG
    plugin (mode 1) refuse it, as every JAX route does; only libtiff's
    codec (mode 2) reads 12-bit frames."""
    import ctypes

    stream = corpus.jpeg12(corpus.dark12(0, 16, 24), progressive=True)
    path = str(tmp_path / "f12.jpg")
    with open(path, "wb") as f:
        f.write(stream)
    lib = native.decode_lib()
    buf = np.frombuffer(stream, np.uint8)
    out = np.zeros(16 * 24 * 3, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    for mode in (0, 1):
        assert lib.jpeg_dims_mode(native._as_u8p(buf), len(stream),
                                  ctypes.byref(h), ctypes.byref(w), mode) != 0
        assert lib.decode_jpeg_u8_mode(native._as_u8p(buf), len(stream),
                                       native._as_u8p(out), 16, 24, mode) != 0
    assert _jax(path) == {"loader": None, "load": None, "img": None,
                          "hw": None}
    assert _port(path, stream) == _jax(path)


def test_lossless_jpeg_file_without_huffman_tables_refused(tmp_path):
    """A lossless JPEG file that defines no Huffman table: libjpeg-turbo
    3 gives a lossless frame no standard tables (a sequential one gets
    them), so Pillow's JPEG plugin refuses it, and so does the JPEG
    decoder's mode 1 (as mode 2 does in a TIFF,
    ``hm12_lossless_p1_no_dht_38x29.tif``)."""
    src = os.path.join(os.path.dirname(corpus.FOLDER), "torch_pillow_corpus",
                       "lossless_gray_37x53.jpg")
    with open(src, "rb") as f:
        data = corpus.without_dht(f.read())
    path = str(tmp_path / "lossless_no_dht.jpg")
    with open(path, "wb") as f:
        f.write(data)
    assert native.decode_jpeg_pillow(data) is None
    assert _jax(path)["img"] is None
    assert _port(path, data) == _jax(path)


def test_no_12bit_or_ojpeg_file_reaches_pil(monkeypatch):
    """Every file the plugin opens goes to the port's decoders, though PIL
    is importable: 12-bit JPEG and old-style JPEG are not left by their
    tags."""
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
        assert tiff.route(header, data) == "libtiff", name
        assert len(handed) == before, name


# Each rule of Pillow's, libtiff's and libjpeg's that the corpus pins, and
# (at most six of) the corpus files whose routes change when the rule is
# mutated in a copy of yolov5m_tpu_torch/.
RULES = {
    "jidctint.c: PASS1_BITS 1 at 12 bits":
        ["hm12_arith_38x29.tif", "hm12_arith_progressive_38x29.tif",
        "hm12_baseline_38x29.tif", "hm12_dqt16_dc_huge_38x29.tif",
        "hm12_optimized_38x29.tif", "hm12_progressive_38x29.tif"],
    "jidctint.c: the 12-bit range limit wraps past 14 bits":
        ["hm12_dqt16_dc_big_38x29.tif", "hm12_dqt16_dc_huge_38x29.tif",
        "lw12_grey_noise_32x24.tif", "lw12_grey_tiles16_48x40.tif"],
    "libjpeg-turbo 3: a lossless frame gets no standard Huffman tables":
        ["hm12_lossless_p1_no_dht_38x29.tif"],
    "libjpeg-turbo 3: the lossless predictors at 12 bits":
        ["hm12_lossless_p5_38x29.tif"],
    "libjpeg-turbo: 12-bit frames in libtiff's codec only":
        ["hm12_arith_38x29.tif", "hm12_arith_progressive_38x29.tif",
        "hm12_baseline_38x29.tif", "hm12_baseline_no_dht_38x29.tif",
        "hm12_dqt16_dc_big_38x29.tif", "hm12_dqt16_dc_huge_38x29.tif"],
    "libjpeg: 16-bit quantizers dequantize unsigned at 12 bits":
        ["hm12_dqt16_dc_huge_38x29.tif"],
    "libjpeg: a sequential frame without tables takes the standard ones":
        ["hm12_baseline_no_dht_38x29.tif"],
    "libjpeg: block smoothing of a 12-bit progressive frame":
        ["hm12_progressive_dc_only_38x29.tif"],
    "libtiff: JPEGPreDecode's precision against BitsPerSample":
        ["hm12_stream8_bps12_38x29.tif"],
    "libtiff: a zero YCbCr subsampling gives no scanline size":
        ["oj_tables_sub_tag20_40x32.tif", "yc_lzw_sub20_19x13.tif"],
    "libtiff: old-style JPEG has three samples where the tag is missing":
        ["oj_jif_no_spp_tag_40x32.tif", "oj_tables_no_spp_tag_40x32.tif"],
    "libtiff: old-style JPEG in planes with one strip is contiguous":
        ["oj_planar_one_strip_32x24.tif"],
    "libtiff: old-style JPEG is YCbCr where the photometric tag says RGB":
        ["oj_jif_photometric_rgb_40x32.tif",
        "oj_tables_photometric_rgb_40x32.tif"],
    "libtiff: two 12-bit samples in three bytes":
        ["hm12_arith_38x29.tif", "hm12_arith_progressive_38x29.tif",
        "hm12_baseline_38x29.tif", "hm12_baseline_no_dht_38x29.tif",
        "hm12_dqt16_dc_big_38x29.tif", "hm12_dqt16_dc_huge_38x29.tif"],
    "tif_ojpeg: OJPEGSubsamplingCorrect reads the first SOF's sampling":
        ["oj_jif_no_sub_tag_21_40x32.tif",
        "oj_jif_sof_y21_cb11_cr11_32x24.tif",
        "oj_jif_sub_tag21_stream22_40x32.tif",
        "oj_jif_sub_tag44_stream22_40x32.tif"],
    "tif_ojpeg: a JPEGInterchangeFormat length of 0 reads to the file's end":
        ["oj_whole_22_jif_length0_40x32.tif"],
    "tif_ojpeg: a JPEGQTables offset repeated is refused":
        ["oj_tables_q_repeated_40x32.tif"],
    "tif_ojpeg: a failed decode leaves the strile count behind":
        ["oj_jif_strips12_past_eof_32x48.tif",
        "oj_tables_strips12_past_eof_32x48.tif"],
    "tif_ojpeg: a failed search for a plane's SOS starves the open session":
        ["oj_planar_tables_rps16_16x24.tif"],
    "tif_ojpeg: a strip past the end of the file is skipped":
        ["oj_grey_strip0_past_eof_24x24.tif",
        "oj_grey_strip1_past_eof_24x24.tif",
        "oj_grey_strip2_past_eof_24x24.tif",
        "oj_grey_strips12_past_eof_24x24.tif",
        "oj_jif_strip0_past_eof_32x48.tif",
        "oj_jif_strip1_past_eof_32x48.tif"],
    "tif_ojpeg: a strip's MCUs its restart interval":
        ["oj_tables_11_rps8_24x24.tif", "oj_tables_22_rps16_40x48.tif",
        "oj_tables_grey_rps8_24x24.tif", "oj_tables_strip0_count10_32x48.tif",
        "oj_tables_strip0_past_eof_32x48.tif",
        "oj_tables_strip1_count_huge_32x48.tif"],
    "tif_ojpeg: a table tag of more than three values is ignored":
        ["oj_tables_q_count4_40x32.tif"],
    "tif_ojpeg: an RST marker after each strip but the last":
        ["oj_grey_strip0_count10_24x24.tif",
        "oj_grey_strip1_count_huge_24x24.tif",
        "oj_grey_strip2_count0_24x24.tif", "oj_jif_11_rps8_24x24.tif",
        "oj_jif_22_rps16_40x48.tif", "oj_jif_app_com_dri_40x48.tif"],
    "tif_ojpeg: each plane's SOS found by scanning on from the last":
        ["oj_planar_32x24.tif"],
    "tif_ojpeg: its resync_to_restart is an error":
        ["oj_grey_strip0_past_eof_24x24.tif",
        "oj_grey_strip1_offset0_24x24.tif",
        "oj_grey_strip1_past_eof_24x24.tif",
        "oj_jif_strip0_past_eof_32x48.tif", "oj_jif_strip1_offset0_32x48.tif",
        "oj_jif_strip1_past_eof_32x48.tif"],
    "tif_ojpeg: jpeg_start_decompress's sampling against libtiff's":
        ["oj_jif_sof_y11_cb11_cr21_32x24.tif",
        "oj_jif_sof_y31_cb11_cr11_32x24.tif"],
    "tif_ojpeg: past the frame's last row libjpeg reads nothing":
        ["oj_tiled16_22_short_frame_50x40.tif"],
    "tif_ojpeg: raw data repacked into libtiff's sampling blocks":
        ["oj_jif_11_40x32.tif", "oj_jif_11_rps8_24x24.tif",
        "oj_jif_12_40x32.tif", "oj_jif_21_40x32.tif", "oj_jif_21_7x5.tif",
        "oj_jif_22_19x13.tif"],
    "tif_ojpeg: the SOF markers it takes: SOF0, SOF1 and SOF3":
        ["oj_jif_sof1_40x32.tif"],
    "tif_ojpeg: the header read from JPEGInterchangeFormat first":
        ["oj_grey_strip0_count10_24x24.tif",
        "oj_grey_strip1_count_huge_24x24.tif",
        "oj_grey_strip2_count0_24x24.tif", "oj_jif_11_40x32.tif",
        "oj_jif_11_rps8_24x24.tif", "oj_jif_12_40x32.tif"],
    "tif_ojpeg: the source fails where the strips run out":
        ["oj_grey_strip2_past_eof_24x24.tif",
        "oj_jif_strip2_past_eof_32x48.tif",
        "oj_jif_strips12_past_eof_32x48.tif",
        "oj_tables_strip2_past_eof_32x48.tif",
        "oj_tables_strips12_past_eof_32x48.tif"],
    "tif_ojpeg: the stream's DRI over libtiff's":
        ["oj_jif_app_com_dri_40x48.tif"],
    "tif_ojpeg: the tables tags where no SOF is found":
        ["oj_planar_tables_rps16_16x24.tif", "oj_tables_11_40x32.tif",
        "oj_tables_11_rps8_24x24.tif", "oj_tables_12_40x32.tif",
        "oj_tables_21_40x32.tif", "oj_tables_21_7x5.tif"],
    "tif_ojpeg: tiles are the rows of one frame a tile wide":
        ["oj_tiled16_11_50x40.tif", "oj_tiled16_22_50x40.tif",
        "oj_tiled16_22_short_frame_50x40.tif", "oj_tiled16_42_50x40.tif",
        "oj_tiled32_22_50x40.tif"],
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_cases_equal_jax(rule):
    assert RULES[rule]
    for name in RULES[rule]:
        path = os.path.join(corpus.FOLDER, name)
        assert _port(path, _read(name)) == DIGESTS[name], name


def _uninitialised(data: bytes) -> bool:
    """A file whose Pillow pixels come in part from a buffer Pillow never
    initialised: a 12-bit JPEG TIFF of odd width, or a JPEG chunk whose
    frame is narrower or shorter than its segment (libtiff leaves the
    rest of the buffer as it was)."""
    try:
        tiff.open_tiff(data)            # past Pillow's bomb limit: refused
        ldir = tiff.libtiff_dir(data)
    except (tiff.NotTiff, ValueError):
        return False
    if ldir.compression != 7:
        return False
    if ldir.bps == 12 and ldir.width % 2:
        return True
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
    got = corpus.digest(_without_pil(native.decode_image, data))
    assert got == want


@functools.cache
def _small_names() -> tuple:
    return tuple(n for n in NAMES if not n.startswith("scene_"))


@st.composite
def changed_files(draw):
    """A corpus file (but the scenes) with one to three bytes changed."""
    data = bytearray(_read(draw(st.sampled_from(_small_names()))))
    for _ in range(draw(st.integers(1, 3))):
        data[draw(st.integers(0, len(data) - 1))] = draw(st.integers(0, 255))
    return bytes(data)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(data=changed_files())
def test_changed_bytes_equal_pillow(data):
    assume(not _uninitialised(data))
    _equal_on_the_server_route(data)


@st.composite
def encoded_12bit(draw):
    """A 12-bit JPEG TIFF of libjpeg-turbo's streams: size (even widths),
    strips, samples, and the encoder's settings."""
    h = draw(st.integers(1, 40))
    w = 2 * draw(st.integers(1, 20))
    kind = draw(st.sampled_from(("dark", "noise", "edges")))
    rng = np.random.default_rng(draw(st.integers(0, 99)))
    px = {"dark": corpus.dark12(int(rng.integers(99)), h, w),
          "noise": rng.integers(0, 4096, (h, w)),
          "edges": np.where(rng.random((h, w)) < 0.5, 0, 4095)}[kind]
    opts = {}
    if draw(st.booleans()):
        opts["lossless"] = draw(st.integers(1, 7))
        opts["pt"] = draw(st.integers(0, 3))
    else:
        opts.update(quality=draw(st.integers(1, 100)),
                    progressive=draw(st.booleans()),
                    arith=draw(st.booleans()),
                    optimize=draw(st.booleans()),
                    restart=draw(st.sampled_from((0, 0, 1, 3))))
    return corpus.tiff12(px, draw(st.sampled_from((0, 8, 16))), **opts)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(data=encoded_12bit())
def test_random_12bit_files_equal_pillow(data):
    from PIL import Image

    _equal_on_the_server_route(data)
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im)
    got = tiff._load_libtiff(data, tiff.open_tiff(data))
    np.testing.assert_array_equal(got, want)


@st.composite
def ojpeg_files(draw):
    """An old-style JPEG TIFF of the numpy encoder: the header's source,
    subsampling, strips, one or three samples, size."""
    grey = draw(st.booleans())
    sub = (1, 1) if grey else draw(st.sampled_from(
        ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2))))
    h = draw(st.integers(1, 48))
    w = draw(st.integers(1, 48))
    rps = draw(st.sampled_from((0, 0, 1, 2))) * 8 * sub[1]
    rgb = tj.picture(draw(st.integers(0, 9)), h, w)
    return corpus.ojpeg_file(rgb, sub, rps, draw(st.sampled_from(
        ("jif", "tables", "whole", "strip0"))), grey=grey)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(data=ojpeg_files())
def test_random_ojpeg_files_equal_pillow(data):
    _equal_on_the_server_route(data)


def test_scene_pixels_are_the_scenes():
    """The old-style JPEG scenes decode to the scene the card's twins are
    made of, within JPEG's loss; the 12-bit one to its grey (the mean of
    its channels)."""
    scene = torch_jpeg_fixtures.scene(0).astype(np.int64)
    grey = np.repeat(scene.sum(-1, keepdims=True) // 3, 3, -1)
    for name in corpus.SCENES:
        img = _without_pil(native.decode_image, _read(name)).astype(np.int64)
        want = scene if "oj" in name else grey
        assert np.abs(img - want).mean() < 8, name
