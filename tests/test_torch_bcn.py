"""DDS, BLP and FTEX as the port reads them (data/bcn.py,
csrc/bcn_decode.cc, the BLP1 JPEG through csrc/jpeg_decode.cc) against the
JAX package's routes, which hand them to Pillow 12.1.0, on the same bytes,
with PIL unimportable for the port.

Every file of the committed corpus (tests/torch_bcn_corpus.py) and the
made 640x480 scenes give, bitwise, what each JAX route gives, or fail
where it fails, at Pillow's size. Also: the committed digests equal the
JAX routes here and the generator remakes the corpus byte for byte; a
sweep of random blocks of every pixel format of Pillow's "bcn" decoder
(DXT1, DXT3, DXT5, BC4, BC5, BC5S, BC6H, BC6HS, BC7) and of BLP2's own
DXT1, DXT3 and DXT5 decoders (alpha flag both ways) equals Pillow's
pixels, alpha included; the open reads Pillow's mode and size; no DDS,
BLP or FTEX file reaches PIL; for each rule the corpus pins, the files
that fail when the rule is mutated in a copy of the port; and a bounded
sweep of corpus files with changed and cut bytes against Pillow.
"""

import io
import os
import sys
import tempfile
import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from tests import torch_bcn_corpus as corpus
from tests import torch_tiff_corpus as tc
from yolov5m_tpu_torch.data import bcn, formats, native

torch.set_num_threads(1)

DIGESTS = corpus.load()
MADE = corpus.made()
NAMES = sorted(n for n in DIGESTS if n not in MADE)


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


@pytest.mark.parametrize("name", NAMES)
def test_corpus_file_equals_jax(name):
    path = os.path.join(corpus.FOLDER, name)
    assert _port(path, _read(name)) == DIGESTS[name]


def test_scenes_equal_jax(tmp_path):
    """The made 640x480 scenes decode on every route to Pillow's pixels at
    Pillow's size, as chip_smoke.py's 9t reads them on the card."""
    assert sorted(MADE) == sorted(corpus.SCENES)
    for name in corpus.SCENES:
        want = DIGESTS[name]
        assert want["hw"] == [480, 640] and want["img"], name
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
    assert total < 1_000_000


# -- random blocks against Pillow ---------------------------------------------

# pixel format -> (the "bcn" decoder's n, signed, FourCC, DXGI format)
BCN = {"DXT1": (1, 0, b"DXT1", None), "DXT3": (2, 0, b"DXT3", None),
       "DXT5": (3, 0, b"DXT5", None), "BC4": (4, 0, b"BC4U", None),
       "BC5": (5, 0, b"BC5U", None), "BC5S": (5, 1, b"BC5S", None),
       "BC6H": (6, 0, b"DX10", 95), "BC6HS": (6, 1, b"DX10", 96),
       "BC7": (7, 0, b"DX10", 98)}
SWEEP = 4              # images a format, of 32 x 32 blocks each


@pytest.mark.parametrize("fmt", sorted(BCN))
def test_random_blocks_equal_pillow(fmt):
    """4096 random blocks (every BC7 mode and a first byte of 0, every
    BC6H mode code) against Pillow's "bcn" decoder, every channel of the
    mode Pillow decodes to."""
    from PIL import Image

    n, sign, fourcc, dxgi = BCN[fmt]
    for k in range(SWEEP):
        blocks = corpus.random_blocks(1000 * n + 10 * sign + k, 1024, n)
        data = corpus.dds(128, 128, corpus.FOURCC, blocks, fourcc,
                          dxgi=dxgi)
        with Image.open(io.BytesIO(data)) as im:
            want = np.asarray(im)
        got = bcn.bcn_pixels(data, len(data) - len(blocks), (128, 128), n,
                             sign)
        got = got[..., 0] if want.ndim == 2 else got[..., :want.shape[2]]
        assert np.array_equal(got, want), (fmt, k)


@pytest.mark.parametrize("enc", [0, 1, 7])
@pytest.mark.parametrize("alpha", [0, 1])
def test_random_blp2_dxt_blocks_equal_pillow(enc, alpha):
    """BLP2's own DXT1 (0), DXT3 (1) and DXT5 (7) decoders over 2048
    random blocks against Pillow's, at a width that skews the rows; every
    channel of the mode Pillow decodes to."""
    from PIL import Image

    n = {0: 1, 1: 2, 7: 3}[enc]
    for k, (w, h) in enumerate(((126, 64), (128, 61))):
        count = ((w + 3) // 4) * ((h + 3) // 4)
        blocks = corpus.random_blocks(2000 + 10 * enc + 2 * alpha + k,
                                      count, n)
        data = corpus.blp2(w, h, blocks, alpha=alpha, alpha_encoding=enc)
        with Image.open(io.BytesIO(data)) as im:
            want = np.asarray(im)
        stream = bcn._blp_dxt(data, len(data) - len(blocks), (w, h), enc,
                              bool(alpha))
        c = want.shape[2]
        got = np.frombuffer(stream, np.uint8, w * h * c).reshape(h, w, c)
        assert np.array_equal(got, want), (enc, alpha, k)


# -- the open and the router --------------------------------------------------

def test_open_equals_pillows_open():
    """The port's open against Pillow's on every corpus file Pillow opens
    (and on the scenes): the plugin, the mode and the size."""
    from PIL import Image

    opened = set()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name in NAMES + sorted(MADE):
            data = _read(name)
            try:
                im = Image.open(io.BytesIO(data))
            except Exception:
                assert formats.pick(data) is None or \
                    formats.pick(data).refused, name
                continue
            got = formats.pick(data)
            assert got.name == im.format, name
            assert got.opened.mode == im.mode, name
            assert tuple(got.opened.size) == im.size, name
            opened.add((im.format, im.mode))
    assert opened >= {("DDS", "RGBA"), ("DDS", "RGB"), ("DDS", "L"),
                      ("DDS", "LA"), ("DDS", "P"), ("BLP", "RGB"),
                      ("BLP", "RGBA"), ("FTEX", "RGBA"), ("FTEX", "RGB"),
                      ("SPIDER", "F")}


def test_no_file_reaches_pil(monkeypatch, tmp_path):
    """No corpus file or scene is handed to PIL, though PIL is importable:
    the port reads or refuses every DDS, BLP and FTEX file itself."""
    handed = []
    monkeypatch.setattr(native, "_decode_other",
                        lambda data: handed.append(bytes(data)))
    for name in NAMES + sorted(MADE):
        data = _read(name)
        path = _path(name, str(tmp_path))
        native.decode_image(data)
        _attempt(native.load_image_pillow, path)
        _attempt(native.load_image_rgb, path)
    assert handed == []


def test_corpus_covers_what_it_claims():
    """Every pixel format of DDS, BLP's encodings and FTEX's formats, the
    refusals and the files passed on."""
    from PIL import Image

    kinds = set()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name in NAMES:
            try:
                im = Image.open(io.BytesIO(_read(name)))
            except Exception:
                continue
            kinds.add((im.format, getattr(im, "pixel_format", None),
                       im.tile[0][0] if im.tile else None))
    for pf in ("DXT1", "DXT3", "DXT5", "BC1", "BC2", "BC3", "BC4", "BC5",
               "BC5S", "BC6H", "BC6HS", "BC7"):
        assert ("DDS", pf, "bcn") in kinds, pf
    assert {("DDS", None, "dds_rgb"), ("DDS", None, "raw"),
            ("BLP", None, "BLP1"), ("BLP", None, "BLP2"),
            ("FTEX", None, "bcn"), ("FTEX", None, "raw")} <= kinds
    refused = {n for n in NAMES if DIGESTS[n]["img"] is None}
    for name in ("dds_dxt1_cut_20x12.dds", "dds_header_size_100_20x12.dds",
                 "dds_dx10_bc1_srgb_20x12.dds", "blp2_palette_cut_8x12.blp",
                 "blp1_jpeg_narrower_than_blp_20x12.blp",
                 "ftex_format_count2_19x13.ftc",
                 "ftex_where_negative_19x13.ftc"):
        assert name in refused, name
    for name in ("dds_rgb565_cut_13x9.dds", "blp1_jpeg_skip_back_17x12.blp",
                 "ftex_mipmap_size_negative_19x13.ftc",
                 "blp1_jpeg_wider_than_blp_13x12.blp"):
        assert name not in refused, name
    assert DIGESTS["ftex_where_past_end_19x13.ftc"]["hw"] is None


# Each rule of Pillow's that the corpus pins, and the corpus files whose
# routes change when the rule is mutated in a copy of yolov5m_tpu_torch/
# (one mutation a rule).
RULES = {
    "5:6:5 endpoints of the bcn decoder copy their top bits down":
        ["dds_dx10_bc1_13x7.dds",
        "dds_dx10_bc1_20x12.dds",
        "dds_dx10_bc1_typeless_13x7.dds",
        "dds_dx10_bc1_typeless_20x12.dds",
        "dds_dx10_bc2_13x7.dds",
        "dds_dx10_bc2_20x12.dds",
        "dds_dx10_bc2_typeless_13x7.dds",
        "dds_dx10_bc2_typeless_20x12.dds",
        "dds_dx10_bc3_13x7.dds",
        "dds_dx10_bc3_20x12.dds",
        "dds_dx10_bc3_typeless_13x7.dds",
        "dds_dx10_bc3_typeless_20x12.dds",
        "dds_dxt1_three_colours_8x4.dds",
        "dds_dxt5_tail_20x12.dds",
        "dds_pillow_bc2_rgba_19x13.dds",
        "dds_pillow_bc3_rgba_19x13.dds",
        "dds_pillow_dxt1_rgb_16x8.dds",
        "dds_pillow_dxt1_rgb_19x13.dds",
        "dds_pillow_dxt1_rgba_19x13.dds",
        "dds_pillow_dxt3_rgba_19x13.dds",
        "dds_pillow_dxt5_rgba_19x13.dds",
        "ftex_dxt1_19x13.ftc",
        "ftex_mipmap_size_minus5_19x13.ftc",
        "ftex_mipmap_size_negative_19x13.ftc",
        "scene_dds_dxt1_640x480.dds",
        "scene_ftex_dxt1_640x480.ftc"],
    "BC1: three colours and black where the first colour is not above "
    "the second":
        ["dds_dx10_bc1_13x7.dds",
        "dds_dx10_bc1_20x12.dds",
        "dds_dx10_bc1_typeless_13x7.dds",
        "dds_dx10_bc1_typeless_20x12.dds",
        "dds_dxt1_three_colours_8x4.dds",
        "dds_pillow_dxt1_rgba_19x13.dds",
        "ftex_dxt1_19x13.ftc",
        "ftex_mipmap_size_minus5_19x13.ftc",
        "ftex_mipmap_size_negative_19x13.ftc"],
    "BC2 and BC3: colours always from four, whatever their order":
        ["dds_dx10_bc2_13x7.dds",
        "dds_dx10_bc2_20x12.dds",
        "dds_dx10_bc2_typeless_13x7.dds",
        "dds_dx10_bc2_typeless_20x12.dds",
        "dds_dx10_bc3_13x7.dds",
        "dds_dx10_bc3_20x12.dds",
        "dds_dx10_bc3_typeless_13x7.dds",
        "dds_dx10_bc3_typeless_20x12.dds",
        "dds_dxt5_tail_20x12.dds"],
    "BC3, BC4 and BC5: four values, then 0 and 255, where the first "
    "endpoint is not above the second":
        ["dds_dx10_bc4_13x7.dds",
        "dds_dx10_bc4_20x12.dds",
        "dds_dx10_bc4_typeless_13x7.dds",
        "dds_dx10_bc4_typeless_20x12.dds",
        "dds_dx10_bc5_13x7.dds",
        "dds_dx10_bc5_20x12.dds",
        "dds_dx10_bc5_snorm_13x7.dds",
        "dds_dx10_bc5_snorm_20x12.dds",
        "dds_dx10_bc5_typeless_13x7.dds",
        "dds_dx10_bc5_typeless_20x12.dds",
        "dds_fourcc_ati1_20x12.dds",
        "dds_fourcc_ati2_20x12.dds",
        "dds_fourcc_bc4u_20x12.dds",
        "dds_fourcc_bc5s_20x12.dds",
        "dds_fourcc_bc5u_20x12.dds",
        "dds_pillow_bc5_rgb_19x13.dds"],
    "BC5S: blue 128":
        ["dds_dx10_bc5_snorm_13x7.dds",
        "dds_dx10_bc5_snorm_20x12.dds",
        "dds_fourcc_bc5s_20x12.dds"],
    "BC5S: each endpoint + 128, then the unsigned palette":
        ["dds_dx10_bc5_snorm_13x7.dds",
        "dds_dx10_bc5_snorm_20x12.dds",
        "dds_fourcc_bc5s_20x12.dds"],
    "BC6H signed: a negative lerp is a negative half (black)":
        ["dds_dx10_bc6h_sf16_13x7.dds",
        "dds_dx10_bc6h_sf16_20x12.dds",
        "dds_dx10_bc6h_sf16_modes_32x16.dds"],
    "BC6H signed: the base endpoint sign-extended":
        ["dds_dx10_bc6h_sf16_13x7.dds",
        "dds_dx10_bc6h_sf16_20x12.dds",
        "dds_dx10_bc6h_sf16_modes_32x16.dds"],
    "BC6H unsigned: half bits v * 31 / 64":
        ["dds_dx10_bc6h_uf16_13x7.dds",
        "dds_dx10_bc6h_uf16_20x12.dds",
        "dds_dx10_bc6h_uf16_modes_32x16.dds",
        "dds_dx10_bc6h_uf16_small_16x16.dds",
        "scene_dds_bc6h_640x480.dds"],
    "BC6H unsigned: the top code unquantizes to 0xffff":
        ["dds_dx10_bc6h_uf16_modes_32x16.dds"],
    "BC6H: a half in [0, 1] truncated to 8 bits":
        ["dds_dx10_bc6h_sf16_13x7.dds",
        "dds_dx10_bc6h_sf16_20x12.dds",
        "dds_dx10_bc6h_sf16_modes_32x16.dds",
        "dds_dx10_bc6h_sf16_small_16x16.dds",
        "dds_dx10_bc6h_uf16_13x7.dds",
        "dds_dx10_bc6h_uf16_20x12.dds",
        "dds_dx10_bc6h_uf16_modes_32x16.dds",
        "dds_dx10_bc6h_uf16_small_16x16.dds",
        "scene_dds_bc6h_640x480.dds"],
    "BC6H: a reserved mode is black":
        ["dds_dx10_bc6h_sf16_modes_32x16.dds",
        "dds_dx10_bc6h_uf16_modes_32x16.dds"],
    "BC6H: deltas added and masked, not sign-extended again":
        ["dds_dx10_bc6h_sf16_13x7.dds",
        "dds_dx10_bc6h_sf16_20x12.dds",
        "dds_dx10_bc6h_sf16_modes_32x16.dds"],
    "BC6H: the anchor of a two-region block's second region takes a bit less":
        ["dds_dx10_bc6h_sf16_13x7.dds",
        "dds_dx10_bc6h_sf16_20x12.dds",
        "dds_dx10_bc6h_sf16_modes_32x16.dds",
        "dds_dx10_bc6h_uf16_13x7.dds",
        "dds_dx10_bc6h_uf16_20x12.dds",
        "dds_dx10_bc6h_uf16_modes_32x16.dds"],
    "BC7: a first byte of 0 is opaque black":
        ["dds_dx10_bc7_20x12.dds",
        "dds_dx10_bc7_first_byte0_16x16.dds",
        "dds_dx10_bc7_modes_36x16.dds",
        "dds_dx10_bc7_srgb_20x12.dds",
        "dds_dx10_bc7_typeless_20x12.dds"],
    "BC7: endpoints widened by copying their top bits down":
        ["dds_dx10_bc7_13x7.dds",
        "dds_dx10_bc7_20x12.dds",
        "dds_dx10_bc7_first_byte0_16x16.dds",
        "dds_dx10_bc7_modes_36x16.dds",
        "dds_dx10_bc7_srgb_13x7.dds",
        "dds_dx10_bc7_srgb_20x12.dds",
        "dds_dx10_bc7_typeless_13x7.dds",
        "dds_dx10_bc7_typeless_20x12.dds"],
    "BC7: lerps round (+ 32)":
        ["dds_dx10_bc7_13x7.dds",
        "dds_dx10_bc7_20x12.dds",
        "dds_dx10_bc7_first_byte0_16x16.dds",
        "dds_dx10_bc7_modes_36x16.dds",
        "dds_dx10_bc7_srgb_13x7.dds",
        "dds_dx10_bc7_srgb_20x12.dds",
        "dds_dx10_bc7_typeless_13x7.dds",
        "dds_dx10_bc7_typeless_20x12.dds",
        "scene_dds_bc7_640x480.dds"],
    "BC7: mode 1's p-bits one a subset":
        ["dds_dx10_bc7_13x7.dds",
        "dds_dx10_bc7_20x12.dds",
        "dds_dx10_bc7_first_byte0_16x16.dds",
        "dds_dx10_bc7_modes_36x16.dds",
        "dds_dx10_bc7_srgb_20x12.dds",
        "dds_dx10_bc7_typeless_20x12.dds"],
    "BC7: mode 4's index selection swaps the colour and alpha indices":
        ["dds_dx10_bc7_13x7.dds",
        "dds_dx10_bc7_20x12.dds",
        "dds_dx10_bc7_first_byte0_16x16.dds",
        "dds_dx10_bc7_modes_36x16.dds",
        "dds_dx10_bc7_srgb_13x7.dds",
        "dds_dx10_bc7_srgb_20x12.dds",
        "dds_dx10_bc7_typeless_13x7.dds",
        "dds_dx10_bc7_typeless_20x12.dds"],
    "BC7: modes 4 and 5 rotate alpha into a colour":
        ["dds_dx10_bc7_13x7.dds",
        "dds_dx10_bc7_20x12.dds",
        "dds_dx10_bc7_first_byte0_16x16.dds",
        "dds_dx10_bc7_modes_36x16.dds",
        "dds_dx10_bc7_srgb_13x7.dds",
        "dds_dx10_bc7_srgb_20x12.dds",
        "dds_dx10_bc7_typeless_13x7.dds",
        "dds_dx10_bc7_typeless_20x12.dds"],
    "BLP1 JPEG: a skip to a first offset behind the reads reads nothing":
        ["blp1_jpeg_skip_back_17x12.blp"],
    "BLP1 JPEG: jpegmode CMYK, a YCCK frame read as CMYK":
        ["blp1_jpeg_ycck_37x53.blp"],
    "BLP1 JPEG: the JPEG's RGB set as BGR":
        ["blp1_jpeg_alpha_17x12.blp",
        "blp1_jpeg_cmyk_17x12.blp",
        "blp1_jpeg_skip_17x12.blp",
        "blp1_jpeg_skip_back_17x12.blp",
        "blp1_jpeg_wider_than_blp_13x12.blp",
        "blp1_jpeg_ycbcr_17x12.blp",
        "blp1_jpeg_ycck_37x53.blp"],
    "BLP2 DXT1: three colours and black where the first colour is not "
    "above the second":
        ["blp2_dxt1_alpha0_1x6.blp",
        "blp2_dxt1_alpha0_5x6.blp",
        "blp2_dxt1_alpha0_6x6.blp",
        "blp2_dxt1_alpha0_7x6.blp",
        "blp2_dxt1_alpha1_5x6.blp",
        "blp2_dxt1_alpha1_6x6.blp",
        "blp2_dxt1_alpha1_7x6.blp"],
    "BLP2 DXT3 and DXT5: four bytes a pixel, read three a pixel without alpha":
        ["blp2_dxt3_alpha0_1x6.blp",
        "blp2_dxt3_alpha0_5x6.blp",
        "blp2_dxt3_alpha0_6x6.blp",
        "blp2_dxt3_alpha0_7x6.blp",
        "blp2_dxt5_alpha0_1x6.blp",
        "blp2_dxt5_alpha0_5x6.blp",
        "blp2_dxt5_alpha0_6x6.blp",
        "blp2_dxt5_alpha0_7x6.blp"],
    "BLP2 DXT3: 4-bit alpha times 17":
        ["blp2_dxt3_alpha0_1x6.blp",
        "blp2_dxt3_alpha0_5x6.blp",
        "blp2_dxt3_alpha0_6x6.blp",
        "blp2_dxt3_alpha0_7x6.blp"],
    "BLP2 DXT5: the eight-value alpha palette":
        ["blp2_dxt5_alpha0_1x6.blp",
        "blp2_dxt5_alpha0_7x6.blp"],
    "BLP2 DXT: 5:6:5 shifted up without the low bits":
        ["blp2_dxt1_alpha0_1x6.blp",
        "blp2_dxt1_alpha0_5x6.blp",
        "blp2_dxt1_alpha0_6x6.blp",
        "blp2_dxt1_alpha0_7x6.blp",
        "blp2_dxt1_alpha1_1x6.blp",
        "blp2_dxt1_alpha1_5x6.blp",
        "blp2_dxt1_alpha1_6x6.blp",
        "blp2_dxt1_alpha1_7x6.blp",
        "blp2_dxt3_alpha0_5x6.blp",
        "blp2_dxt3_alpha0_6x6.blp",
        "blp2_dxt3_alpha0_7x6.blp",
        "blp2_dxt3_alpha1_1x6.blp",
        "blp2_dxt3_alpha1_5x6.blp",
        "blp2_dxt3_alpha1_6x6.blp",
        "blp2_dxt3_alpha1_7x6.blp",
        "blp2_dxt5_alpha0_1x6.blp",
        "blp2_dxt5_alpha0_5x6.blp",
        "blp2_dxt5_alpha0_6x6.blp",
        "blp2_dxt5_alpha0_7x6.blp",
        "blp2_dxt5_alpha1_1x6.blp",
        "blp2_dxt5_alpha1_5x6.blp",
        "blp2_dxt5_alpha1_6x6.blp",
        "blp2_dxt5_alpha1_7x6.blp",
        "scene_blp2_dxt5_640x480.blp"],
    "BLP2 DXT: each block row's pixel rows the padded width long, one stream":
        ["blp2_dxt1_alpha0_1x6.blp",
        "blp2_dxt1_alpha0_5x6.blp",
        "blp2_dxt1_alpha0_6x6.blp",
        "blp2_dxt1_alpha0_7x6.blp",
        "blp2_dxt1_alpha1_1x6.blp",
        "blp2_dxt1_alpha1_5x6.blp",
        "blp2_dxt1_alpha1_6x6.blp",
        "blp2_dxt1_alpha1_7x6.blp",
        "blp2_dxt3_alpha0_1x6.blp",
        "blp2_dxt3_alpha0_5x6.blp",
        "blp2_dxt3_alpha0_6x6.blp",
        "blp2_dxt3_alpha0_7x6.blp",
        "blp2_dxt3_alpha1_1x6.blp",
        "blp2_dxt3_alpha1_5x6.blp",
        "blp2_dxt3_alpha1_6x6.blp",
        "blp2_dxt3_alpha1_7x6.blp",
        "blp2_dxt5_alpha0_1x6.blp",
        "blp2_dxt5_alpha0_5x6.blp",
        "blp2_dxt5_alpha0_6x6.blp",
        "blp2_dxt5_alpha0_7x6.blp",
        "blp2_dxt5_alpha1_1x6.blp",
        "blp2_dxt5_alpha1_5x6.blp",
        "blp2_dxt5_alpha1_6x6.blp",
        "blp2_dxt5_alpha1_7x6.blp"],
    "BLP2: the palette's indices at the first offset":
        ["blp2_palette_offset_gap_8x12.blp"],
    "BLP: palette entries B, G, R, A":
        ["blp1_palette_alpha_8x12.blp",
        "blp1_palette_encoding4_8x12.blp",
        "blp1_pillow_p_19x13.blp",
        "blp1_pillow_pa_19x13.blp",
        "blp2_palette_lengths_long_8x12.blp",
        "blp2_palette_offset_gap_8x12.blp",
        "blp2_pillow_p_19x13.blp",
        "blp2_pillow_pa_19x13.blp",
        "scene_blp1_palette_640x480.blp"],
    "BLP: the 1024-byte palette read first, for DXT too":
        ["blp2_dxt1_short_palette_8x12.blp"],
    "BLP: too few pixels fail the load (not enough image data)":
        ["blp1_jpeg_narrower_than_blp_20x12.blp",
        "blp2_palette_lengths_short_8x12.blp"],
    "DDS: 16-bit luminance needs the alpha flag":
        ["dds_lum16_no_alpha_20x12.dds"],
    "DDS: BC1's sRGB DXGI format is not read":
        ["dds_dx10_bc1_srgb_20x12.dds"],
    "DDS: P's palette RGBA, its fourth byte dropped":
        ["dds_p8_rgba_palette_13x9.dds"],
    "DDS: pixels where the open left the file (after P's palette, after "
    "DX10's header)":
        ["dds_dx10_bc1_13x7.dds",
        "dds_dx10_bc1_20x12.dds",
        "dds_dx10_bc1_typeless_13x7.dds",
        "dds_dx10_bc1_typeless_20x12.dds",
        "dds_dx10_bc2_13x7.dds",
        "dds_dx10_bc2_20x12.dds",
        "dds_dx10_bc2_typeless_13x7.dds",
        "dds_dx10_bc2_typeless_20x12.dds",
        "dds_dx10_bc3_13x7.dds",
        "dds_dx10_bc3_20x12.dds",
        "dds_dx10_bc3_typeless_13x7.dds",
        "dds_dx10_bc3_typeless_20x12.dds",
        "dds_dx10_bc4_13x7.dds",
        "dds_dx10_bc4_20x12.dds",
        "dds_dx10_bc4_typeless_13x7.dds",
        "dds_dx10_bc4_typeless_20x12.dds",
        "dds_dx10_bc5_13x7.dds",
        "dds_dx10_bc5_20x12.dds",
        "dds_dx10_bc5_snorm_13x7.dds",
        "dds_dx10_bc5_snorm_20x12.dds",
        "dds_dx10_bc5_typeless_13x7.dds",
        "dds_dx10_bc5_typeless_20x12.dds",
        "dds_dx10_bc6h_sf16_13x7.dds",
        "dds_dx10_bc6h_sf16_20x12.dds",
        "dds_dx10_bc6h_sf16_modes_32x16.dds",
        "dds_dx10_bc6h_sf16_small_16x16.dds",
        "dds_dx10_bc6h_uf16_13x7.dds",
        "dds_dx10_bc6h_uf16_20x12.dds",
        "dds_dx10_bc6h_uf16_modes_32x16.dds",
        "dds_dx10_bc6h_uf16_small_16x16.dds",
        "dds_dx10_bc7_13x7.dds",
        "dds_dx10_bc7_20x12.dds",
        "dds_dx10_bc7_cut_20x12.dds",
        "dds_dx10_bc7_first_byte0_16x16.dds",
        "dds_dx10_bc7_modes_36x16.dds",
        "dds_dx10_bc7_srgb_13x7.dds",
        "dds_dx10_bc7_srgb_20x12.dds",
        "dds_dx10_bc7_typeless_13x7.dds",
        "dds_dx10_bc7_typeless_20x12.dds",
        "dds_dx10_r8g8b8a8_srgb_13x9.dds",
        "dds_dx10_r8g8b8a8_typeless_13x9.dds",
        "dds_dx10_r8g8b8a8_unorm_13x9.dds",
        "dds_p8_cut_13x9.dds",
        "dds_p8_rgba_palette_13x9.dds",
        "dds_p8_short_palette_13x9.dds",
        "dds_pillow_bc2_rgba_19x13.dds",
        "dds_pillow_bc3_rgba_19x13.dds",
        "dds_pillow_bc5_rgb_19x13.dds",
        "scene_dds_bc6h_640x480.dds",
        "scene_dds_bc7_640x480.dds"],
    "FTEX: a format count other than 1 fails the open":
        ["ftex_format_count2_19x13.ftc"],
    "FTEX: a mipmap past the end passes the file on (to SPIDER)":
        ["ftex_spider_6x5.spi",
        "ftex_where_past_end_19x13.ftc"],
    "FTEX: a negative mipmap size reads to the end":
        ["ftex_mipmap_size_minus5_19x13.ftc",
        "ftex_mipmap_size_negative_19x13.ftc"],
    "bcn: a block stream cut short fails the load":
        ["dds_dx10_bc7_cut_20x12.dds",
        "dds_dxt1_cut_20x12.dds",
        "ftex_mipmap_cut_19x13.ftc",
        "ftex_mipmap_size_short_19x13.ftc",
        "ftex_where_in_header_4x4.ftc"],
    "dds_rgb: a field's scale is its mask shifted down, gaps and all":
        ["dds_gapped_32bit_13x9.dds"],
    "dds_rgb: a pixel wider than 4 bytes keeps its first 4":
        ["dds_bitcount40_13x9.dds"],
    "dds_rgb: a read past the file's end is 0":
        ["dds_rgb565_cut_13x9.dds"],
    "dds_rgb: fields scaled in double, truncated":
        ["dds_gapped_32bit_13x9.dds"],
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_cases_equal_jax(rule, tmp_path):
    assert RULES[rule]
    for name in RULES[rule]:
        assert _port(_path(name, str(tmp_path)), _read(name)) == \
            DIGESTS[name], name


@st.composite
def changed_files(draw):
    """A small corpus file with one to four bytes changed or a bit
    flipped (the headers now and then), or cut."""
    name = draw(st.sampled_from(NAMES))
    out = bytearray(_read(name))
    kind = draw(st.integers(0, 2))
    if kind == 2 or len(out) < 2:
        return name, bytes(out[:draw(st.integers(0, max(len(out) - 1,
                                                           0)))])
    hi = len(out) - 1 if draw(st.booleans()) else min(len(out) - 1, 160)
    for _ in range(draw(st.integers(1, 4)) if kind == 0 else 1):
        at = draw(st.integers(0, hi))
        out[at] = draw(st.integers(0, 255)) if kind == 0 else \
            out[at] ^ (1 << draw(st.integers(0, 7)))
    return name, bytes(out)


@settings(max_examples=400, deadline=None, derandomize=True)
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
