"""CIELab TIFF as the port reads it (data/tiff.py, then data/convert.py over
csrc/lab_convert.cc) against the JAX package's routes, which hand TIFF to
Pillow 12.1.0's TiffImagePlugin (its ``LAB`` mode, over libtiff 4.7.1 where
the file is compressed) and ``convert("RGB")`` (a LittleCMS 2 transform
from its Lab profile to sRGB), on the same bytes, with PIL unimportable for
the port.

Every file of the committed corpus (tests/torch_tiff_lab_corpus.py), and
the uncompressed 640x480 scene it makes, gives, bitwise, what each JAX
route gives, or fails where it fails. Also: the committed digests equal
the JAX routes here and the generator remakes the corpus byte for byte;
the port's transform equals Pillow's on all 2^24 LAB pixels, and the
committed digest of Pillow's (which the card checks) is that of this
machine; no CIELab file reaches PIL; for each rule the corpus pins, the
files that fail when the rule is mutated in a copy of the port; and a
bounded sweep of corpus files with changed bytes against Pillow.
"""

import json
import os
import sys
import tempfile
import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from tests import torch_tiff_corpus as tc
from tests import torch_tiff_lab_corpus as corpus
from yolov5m_tpu_torch.data import convert, native, tiff

torch.set_num_threads(1)

DIGESTS = corpus.load()
NAMES = sorted(DIGESTS)
MADE = corpus.made()


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


@pytest.mark.parametrize("name", NAMES)
def test_corpus_file_equals_jax(name, tmp_path):
    path = os.path.join(corpus.FOLDER, name) if name not in MADE else \
        _on_disk(name, MADE[name], str(tmp_path))
    assert _port(path, _read(name)) == DIGESTS[name]


def test_committed_digests_equal_jax_here(tmp_path):
    """The digests chip_smoke.py holds the port to are the JAX routes'
    pixels and sizes on this machine."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name in NAMES:
            path = os.path.join(corpus.FOLDER, name) if name not in MADE \
                else _on_disk(name, MADE[name], str(tmp_path))
            assert DIGESTS[name] == tc.reference(path), name


def test_corpus_remakes_exactly():
    made = corpus.cases()
    assert sorted([*made, *MADE]) == NAMES
    for name, data in made.items():
        assert data == _read(name), name
    files = [n for n in os.listdir(corpus.FOLDER)
             if n not in (corpus.DIGESTS, corpus.TRANSFORM)]
    assert sorted(files) == sorted(made)
    total = sum(os.path.getsize(os.path.join(corpus.FOLDER, n))
                for n in os.listdir(corpus.FOLDER))
    assert total < 2_500_000
    assert set(corpus.SCENES) | {corpus.ROTATED} <= set(NAMES)


def test_transform_equals_pillow_on_every_pixel():
    """The port's Lab to RGB (lcms's 16-bit table, computed from the
    formulas, and its tetrahedral interpolation, in C) equals Pillow's
    convert("RGB") on all 2^24 LAB pixels; the committed digest the card
    checks is Pillow's here."""
    px = corpus.all_storage()
    port = native.lab_to_srgb(px)
    pillow = corpus.pillow_transform()
    assert np.array_equal(port, pillow)
    with open(os.path.join(corpus.FOLDER, corpus.TRANSFORM)) as f:
        assert json.load(f)["sha256"] == corpus.sha256(pillow)
    # Pillow's own anchors: black and white, mid grey, the corner a = b =
    # -128 at L 0
    for (lum, a, b), rgb in (((0, 128, 128), (1, 0, 1)),
                             ((255, 128, 128), (254, 255, 254)),
                             ((128, 128, 128), (119, 119, 119)),
                             ((0, 0, 0), (0, 59, 195))):
        assert tuple(port[lum * 16 + a // 16, (a % 16) * 256 + b]) == rgb


def test_convert_takes_lab_storage():
    """convert.to_rgb("LAB") reads the first three bytes of Pillow's
    4-byte pixels, whatever the fourth."""
    rng = np.random.default_rng(0)
    px = rng.integers(0, 256, (7, 9, 4), np.uint8)
    other = px.copy()
    other[..., 3] = 255 - other[..., 3]
    assert np.array_equal(convert.to_rgb("LAB", px),
                          convert.to_rgb("LAB", other))
    assert convert.to_rgb("LAB", px).shape == (7, 9, 3)


def test_corpus_covers_what_it_claims():
    """Every codec the port reads under photometric 8, in strips and
    tiles, contiguous and planar, predictor 2, big-endian, BigTIFF,
    Orientation 1-8; what Pillow refuses, refused."""
    decoded = [n for n in NAMES if DIGESTS[n]["img"]]
    kinds = set()
    for name in decoded:
        data = _read(name)
        header = tiff.open_tiff(data)
        assert header.mode == "LAB", name
        d = tiff.libtiff_dir(data)
        kinds.add((d.compression, d.tiled, d.planar))
    assert {k[0] for k in kinds} == {1, 5, 7, 8, 32773, 34925, 50000}
    for codec in (1, 5, 8, 32773, 34925, 50000, 7):
        assert {k[1:] for k in kinds if k[0] == codec} >= \
            {(False, 1), (True, 1), (False, 2), (True, 2)}, codec
    assert {tiff.open_tiff(_read(n)).orientation for n in decoded} >= \
        set(range(1, 9))
    refused = {n for n in NAMES if not DIGESTS[n]["img"]}
    assert refused == {"lw_icclab_37x29.tif", "lw_itulab_37x29.tif",
                       "lw_lab_16bit_37x29.tif", "lw_lab_one_sample_37x29.tif",
                       "lw_lab_extra_sample_37x29.tif",
                       "oj_lab_11_24x16.tif", "oj_lab_22_24x16.tif"}


def test_flagship_scenes_equal_pillow(tmp_path):
    """The 640x480 scenes, uncompressed and LZW, decode on every route to
    Pillow's pixels at Pillow's size."""
    for name in corpus.SCENES + (corpus.ROTATED,):
        assert DIGESTS[name]["hw"] == ([480, 640] if "orient" not in name
                                       else [640, 480]), name
        path = os.path.join(corpus.FOLDER, name) if name not in MADE else \
            _on_disk(name, MADE[name], str(tmp_path))
        assert _port(path, _read(name)) == DIGESTS[name], name


def test_no_lab_reaches_pil(monkeypatch):
    """Every CIELab file Pillow's plugin opens goes to the port's decoders,
    though PIL is importable: photometric 8 is no longer left by its tags,
    and the refusals stay refusals. The files Pillow's plugin passes on
    (a mode it has no entry for) are refused by every other plugin."""
    handed = []
    monkeypatch.setattr(native, "_decode_other",
                        lambda data: handed.append(data))
    passed_on = []
    for name in NAMES:
        data = _read(name)
        try:
            header = tiff.open_tiff(data)
        except tiff.NotTiff:
            passed_on.append(name)
            continue
        native.decode_image(data)
        native.decode_image(data, by_path=True)
        assert tiff.route(header, data) in ("raw", "libtiff"), name
    assert not handed
    assert sorted(passed_on) == ["lw_icclab_37x29.tif", "lw_itulab_37x29.tif",
                                 "lw_lab_16bit_37x29.tif",
                                 "lw_lab_extra_sample_37x29.tif",
                                 "lw_lab_one_sample_37x29.tif"]
    for name in passed_on:
        assert DIGESTS[name] == {"hw": None, "img": None, "load": None,
                                 "loader": None}, name


# Each rule of Pillow's, libtiff's and LittleCMS's that the corpus pins,
# and the corpus files whose routes change when the rule is mutated in a
# copy of yolov5m_tpu_torch/ (one mutation a rule).
RULES = {
    "LittleCMS: 16 bits to 8 as FROM_16_TO_8":
        ["lw_lab_ab_plane_L0_lzw_256x256.tif",
        "lw_lab_ab_plane_L128_lzw_256x256.tif",
        "lw_lab_ab_plane_L1_lzw_256x256.tif",
        "lw_lab_ab_plane_L254_lzw_256x256.tif",
        "lw_lab_ab_plane_L255_lzw_256x256.tif",
        "lw_lab_deflate_bigtiff_37x29.tif"],
    "LittleCMS: 8-bit input widened as x * 257":
        ["lw_lab_ab_plane_L0_lzw_256x256.tif",
        "lw_lab_ab_plane_L128_lzw_256x256.tif",
        "lw_lab_ab_plane_L1_lzw_256x256.tif",
        "lw_lab_ab_plane_L254_lzw_256x256.tif",
        "lw_lab_ab_plane_L255_lzw_256x256.tif",
        "lw_lab_deflate_bigtiff_37x29.tif"],
    "LittleCMS: Lab to XYZ linear below 24/116":
        ["lw_lab_ab_plane_L0_lzw_256x256.tif",
        "lw_lab_ab_plane_L128_lzw_256x256.tif",
        "lw_lab_ab_plane_L1_lzw_256x256.tif",
        "lw_lab_deflate_bigtiff_37x29.tif",
        "lw_lab_deflate_planar_strips_37x29.tif",
        "lw_lab_deflate_planar_tiles_37x29.tif"],
    "LittleCMS: XYZ over its largest encodable value":
        ["lw_lab_ab_plane_L128_lzw_256x256.tif",
        "lw_lab_ab_plane_L1_lzw_256x256.tif"],
    "LittleCMS: _cmsQuickSaturateWord's rounding":
        ["lw_lab_ab_plane_L0_lzw_256x256.tif",
        "lw_lab_ab_plane_L128_lzw_256x256.tif",
        "lw_lab_ab_plane_L1_lzw_256x256.tif",
        "lw_lab_ab_plane_L254_lzw_256x256.tif",
        "lw_lab_ab_plane_L255_lzw_256x256.tif",
        "lw_lab_deflate_bigtiff_37x29.tif"],
    "LittleCMS: a table of 33 points a side":
        ["lw_lab_ab_plane_L0_lzw_256x256.tif",
        "lw_lab_ab_plane_L128_lzw_256x256.tif",
        "lw_lab_ab_plane_L1_lzw_256x256.tif",
        "lw_lab_ab_plane_L254_lzw_256x256.tif",
        "lw_lab_ab_plane_L255_lzw_256x256.tif",
        "lw_lab_deflate_bigtiff_37x29.tif"],
    "LittleCMS: each stage's output rounded to float":
        ["lw_lab_ab_plane_L1_lzw_256x256.tif"],
    "LittleCMS: sRGB's colorants Bradford-adapted to D50":
        ["lw_lab_ab_plane_L0_lzw_256x256.tif",
        "lw_lab_ab_plane_L128_lzw_256x256.tif",
        "lw_lab_ab_plane_L1_lzw_256x256.tif",
        "lw_lab_ab_plane_L254_lzw_256x256.tif",
        "lw_lab_ab_plane_L255_lzw_256x256.tif",
        "lw_lab_deflate_bigtiff_37x29.tif"],
    "LittleCMS: tetrahedral interpolation, axes by their remainders":
        ["lw_lab_ab_plane_L0_lzw_256x256.tif",
        "lw_lab_ab_plane_L128_lzw_256x256.tif",
        "lw_lab_ab_plane_L1_lzw_256x256.tif",
        "lw_lab_ab_plane_L254_lzw_256x256.tif",
        "lw_lab_ab_plane_L255_lzw_256x256.tif",
        "lw_lab_deflate_bigtiff_37x29.tif"],
    "LittleCMS: the inverse sRGB curve linear below (a d + b)^g":
        ["lw_lab_ab_plane_L0_lzw_256x256.tif",
        "lw_lab_ab_plane_L128_lzw_256x256.tif",
        "lw_lab_ab_plane_L1_lzw_256x256.tif",
        "lw_lab_ab_plane_L254_lzw_256x256.tif",
        "lw_lab_ab_plane_L255_lzw_256x256.tif",
        "lw_lab_deflate_bigtiff_37x29.tif"],
    "Pillow: photometric 8 opened as LAB and read here":
        ["lw_lab_ab_plane_L0_lzw_256x256.tif",
        "lw_lab_ab_plane_L128_lzw_256x256.tif",
        "lw_lab_ab_plane_L1_lzw_256x256.tif",
        "lw_lab_ab_plane_L254_lzw_256x256.tif",
        "lw_lab_ab_plane_L255_lzw_256x256.tif",
        "lw_lab_deflate_bigtiff_37x29.tif"],
    "Pillow: planar LAB bands copied as they are":
        ["lw_lab_raw_planar_strips_37x29.tif",
        "lw_lab_raw_planar_tiles_37x29.tif"],
    "Pillow: the LAB unpacker adds 128 to a and b":
        ["lw_lab_ab_plane_L0_lzw_256x256.tif",
        "lw_lab_ab_plane_L128_lzw_256x256.tif",
        "lw_lab_ab_plane_L1_lzw_256x256.tif",
        "lw_lab_ab_plane_L254_lzw_256x256.tif",
        "lw_lab_ab_plane_L255_lzw_256x256.tif",
        "lw_lab_deflate_bigtiff_37x29.tif"],
    "libzstd: a v0.5-v0.7 magic to that version's streaming decoder":
        ["zl_lab_z7_37x29.tif"],
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_cases_equal_jax(rule, tmp_path):
    assert RULES[rule]
    for name in RULES[rule]:
        path = os.path.join(corpus.FOLDER, name) if name not in MADE else \
            _on_disk(name, MADE[name], str(tmp_path))
        assert _port(path, _read(name)) == DIGESTS[name], name


def _changed(draw, data: bytes) -> bytes:
    """data with one to eight bytes changed, or one bit flipped."""
    out = bytearray(data)
    flip = draw(st.booleans())
    for _ in range(1 if flip else draw(st.integers(1, 8))):
        at = draw(st.integers(0, len(out) - 1))
        out[at] = out[at] ^ (1 << draw(st.integers(0, 7))) if flip \
            else draw(st.integers(0, 255))
    return bytes(out)


@st.composite
def changed_files(draw):
    name = draw(st.sampled_from([n for n in NAMES
                                 if not n.startswith("scene")]))
    data = _read(name)
    if draw(st.booleans()):                 # the header and directory
        head = _changed(draw, data[:min(len(data), 400)])
        return name, head + data[len(head):]
    return name, _changed(draw, data)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(case=changed_files())
def test_changed_bytes_equal_pillow(case):
    """Corpus files with bytes changed: every route equals Pillow's."""
    name, data = case
    with tempfile.TemporaryDirectory() as tmp:
        path = _on_disk(name, data, tmp)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = tc.reference(path)
        assert _port(path, data) == want
