"""The CIELab TIFF corpus (tests/fixtures/torch_tiff_lab_corpus/): TIFF of
photometric interpretation 8, which the JAX package hands to Pillow 12.1.0
(TiffImagePlugin opens three 8-bit samples as ``LAB``; ``convert("RGB")``
is a LittleCMS transform from its Lab profile to sRGB) and which the port
reads in data/tiff.py, data/convert.py and csrc/lab_convert.cc.

Small files made from numpy seeds:

- Pillow's writer of a LAB image: uncompressed, LZW, deflate, PackBits
  and JPEG;
- tests/torch_tiff_writer.c over Pillow's libtiff: every codec the port
  reads (uncompressed, LZW, deflate, PackBits, ZSTD, LZMA, JPEG), in
  strips and tiles, contiguous and planar, predictor 2, big-endian,
  BigTIFF and Orientation 1-8;
- a v0.7 zstd frame (tests/torch_tiff_zstd_legacy_corpus.py);
- every a and b at five lightnesses (256x256 images, one a row);
- what Pillow refuses: old-style JPEG under photometric 8 (its open
  forces YCbCr), an extra sample, 16 bits, one sample, ICCLab (9) and
  ITULab (10);
- the 640x480 scene (tests/torch_jpeg_fixtures.py:scene 0, its colours
  taken to L, a and b by a fixed formula) for chip_smoke.py's phase 9p:
  LZW (also under Orientation 6), committed; and uncompressed, which
  ``made()`` writes where it is needed (the card has no encoder the port
  may rely on, and the folder keeps compressed files).

``digests.json`` holds each JAX route's pixels' sha256 and Pillow's size
(tests/torch_tiff_corpus.py:reference), the made scene's too.
``transform.json`` holds the sha256 of Pillow's ``convert("RGB")`` of all
2^24 LAB pixels (L, a + 128, b + 128 as Pillow stores them, in the order
L, a, b of their value), so that the card can check the port's transform
without Pillow. Remake with (Pillow, the JAX package, g++ with the
system's tiffio.h for the writer)

  python -m tests.torch_tiff_lab_corpus [folder]
"""

import hashlib
import json
import os
import sys

import numpy as np


def _sibling(name: str):
    """tests/{name}.py by its path (chip_smoke.py loads this module so)."""
    import importlib.util

    if f"tests.{name}" in sys.modules:
        return sys.modules[f"tests.{name}"]
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


tc = _sibling("torch_tiff_corpus")
tj = _sibling("torch_tiff_jpeg_corpus")

FOLDER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                      "torch_tiff_lab_corpus")
DIGESTS = "digests.json"
TRANSFORM = "transform.json"
# the scenes chip_smoke.py's phase 9p reads (their PPM twins are made
# there): uncompressed (made, not committed) and LZW
SCENES = ("scene_lab_640x480.tif", "scene_lab_lzw_640x480.tif")
MADE = ("scene_lab_640x480.tif",)
# detect --img's file there: the LZW scene under Orientation 6
ROTATED = "scene_lab_lzw_orient6_640x480.tif"


def lab_of(rgb: np.ndarray) -> np.ndarray:
    """(h, w, 3) uint8 CIELab samples as a TIFF holds them (L, then a and
    b as signed bytes) of an RGB picture by a fixed formula."""
    c = rgb.astype(np.int32)
    lum = (54 * c[..., 0] + 183 * c[..., 1] + 19 * c[..., 2]) >> 8
    a = np.clip((c[..., 0] - c[..., 1]) // 2, -128, 127)
    b = np.clip((c[..., 1] - c[..., 2]) // 2, -128, 127)
    return np.stack([lum, a & 255, b & 255], -1).astype(np.uint8)


def raw_lab(lab: np.ndarray, rows_per_strip: int = 0, more=None) -> bytes:
    """An uncompressed contiguous CIELab TIFF, written here."""
    h, w = lab.shape[:2]
    rps = rows_per_strip or h
    tags = tc.tags_for(w, h, 3, 8, 8, rows_per_strip=rps, more=more)
    return tc.tiff_file(tags, tc.strips(lab.tobytes(), w * 3, rps))


def _pillow_cases(out: dict):
    from PIL import Image

    lab = lab_of(tc.picture(11, 13, 19).astype(np.uint8))
    im = Image.frombytes("LAB", (19, 13), lab.tobytes())
    for name, comp in (("raw", None), ("lzw", "tiff_lzw"),
                       ("deflate", "tiff_adobe_deflate"),
                       ("packbits", "packbits"), ("jpeg", "jpeg")):
        out[f"pw_lab_{name}_19x13.tif"] = tc._pillow_saved(
            im, compression=comp)


def _libtiff_cases(out: dict):
    lab = lab_of(tc.picture(12, 29, 37).astype(np.uint8))
    lt = tc.libtiff
    for comp, name in ((1, "raw"), (5, "lzw"), (8, "deflate"),
                       (32773, "packbits"), (50000, "zstd"),
                       (34925, "lzma"), (7, "jpeg")):
        for planar in (1, 2):
            for tile in (0, 16):
                layout = ("planar_" if planar == 2 else "") + \
                    ("tiles" if tile else "strips")
                out[f"lw_lab_{name}_{layout}_37x29.tif"] = lt(
                    lab, photometric=8, compression=comp, planar=planar,
                    tile_width=tile, tile_height=tile)
    for comp, name in ((5, "lzw"), (8, "deflate"), (50000, "zstd")):
        out[f"lw_lab_{name}_pred2_37x29.tif"] = lt(
            lab, photometric=8, compression=comp, predictor=2)
    out["lw_lab_lzw_be_37x29.tif"] = lt(lab, photometric=8, compression=5,
                                       bigendian=1)
    out["lw_lab_raw_be_37x29.tif"] = lt(lab, photometric=8, bigendian=1)
    out["lw_lab_deflate_bigtiff_37x29.tif"] = lt(
        lab, photometric=8, compression=8, bigtiff=1)
    for o in range(1, 9):
        out[f"lw_lab_raw_orient{o}_37x29.tif"] = lt(
            lab, photometric=8, orientation=o, rows_per_strip=29)
        out[f"lw_lab_lzw_orient{o}_37x29.tif"] = lt(
            lab, photometric=8, compression=5, orientation=o)
    # the refusals: an extra sample, 16 bits, one sample, ICCLab, ITULab
    four = np.concatenate([lab, lab[..., :1]], -1)
    out["lw_lab_extra_sample_37x29.tif"] = lt(four, photometric=8,
                                              extra=(0,))
    out["lw_lab_16bit_37x29.tif"] = lt(lab.astype(np.uint16) * 257, bps=16,
                                      photometric=8)
    out["lw_lab_one_sample_37x29.tif"] = lt(lab[..., :1], photometric=8)
    out["lw_icclab_37x29.tif"] = lt(lab, photometric=9)
    out["lw_itulab_37x29.tif"] = lt(lab, photometric=10)


def _hand_cases(out: dict):
    # every a and b at five lightnesses, one a a row
    a, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for light in (0, 1, 128, 254, 255):
        lab = np.stack([np.full_like(a, light), a, b], -1).astype(np.uint8)
        out[f"lw_lab_ab_plane_L{light}_lzw_256x256.tif"] = tc.libtiff(
            lab, photometric=8, compression=5, rows_per_strip=64)
    zs = _sibling("torch_tiff_zstd_legacy_corpus")
    zl = _sibling("torch_zstd_legacy")
    lab = lab_of(tc.picture(13, 29, 37).astype(np.uint8))
    out["zl_lab_z7_37x29.tif"] = zs.legacy_tiff(
        lab, lambda k, data: zl.frame(7, data, checksum=True),
        photometric=8, rows_per_strip=16)
    # old-style JPEG, its Photometric 8: Pillow's open forces YCbCr
    oj = _sibling("torch_tiff_ojpeg_corpus")
    rgb = tc.picture(14, 16, 24).astype(np.uint8)
    for sub in ((1, 1), (2, 2)):
        out[f"oj_lab_{sub[0]}{sub[1]}_24x16.tif"] = oj.ojpeg_file(
            rgb, sub=sub, tags={262: 8})


def scene_lab(rgb: np.ndarray) -> np.ndarray:
    return lab_of(np.ascontiguousarray(rgb, np.uint8))


def made() -> dict:
    """The uncompressed scene (numpy alone: the card makes it too)."""
    torch_jpeg_fixtures = _sibling("torch_jpeg_fixtures")
    lab = scene_lab(torch_jpeg_fixtures.scene(0))
    return {MADE[0]: raw_lab(lab, rows_per_strip=16)}


def scene_cases(rgb: np.ndarray) -> dict:
    """The committed 640x480 scenes for phase 9p."""
    lab = scene_lab(rgb)
    return {
        SCENES[1]: tc.libtiff(lab, photometric=8, compression=5,
                              rows_per_strip=16),
        ROTATED: tc.libtiff(lab, photometric=8, compression=5,
                            rows_per_strip=16, orientation=6),
    }


def cases() -> dict:
    """Every committed file."""
    torch_jpeg_fixtures = _sibling("torch_jpeg_fixtures")
    out = {}
    _pillow_cases(out)
    _libtiff_cases(out)
    _hand_cases(out)
    out.update(scene_cases(torch_jpeg_fixtures.scene(0)))
    return out


def all_storage() -> np.ndarray:
    """Every LAB pixel as Pillow stores it (L, a + 128, b + 128), in the
    order of their value: (4096, 4096, 3) uint8."""
    v = np.arange(1 << 24, dtype=np.uint32)
    px = np.empty((1 << 24, 3), np.uint8)
    px[:, 0] = v >> 16
    px[:, 1] = (v >> 8) & 255
    px[:, 2] = v & 255
    return px.reshape(4096, 4096, 3)


def pillow_transform() -> np.ndarray:
    """Pillow's convert("RGB") of all_storage() (frombytes' "LAB" rawmode
    adds the 128 back)."""
    from PIL import Image

    px = all_storage() ^ np.array([0, 128, 128], np.uint8)
    return np.asarray(Image.frombytes("LAB", (4096, 4096),
                                      px.tobytes()).convert("RGB"))


def sha256(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def load(folder: str = FOLDER, name: str = DIGESTS) -> dict:
    with open(os.path.join(folder, name)) as f:
        return json.load(f)


def write(folder: str = FOLDER) -> dict:
    """Write every committed case, digests.json (the made scene's too) and
    transform.json into folder; returns the digests."""
    import tempfile
    import warnings

    warnings.simplefilter("ignore")
    os.makedirs(folder, exist_ok=True)
    for old in os.listdir(folder):
        if old.endswith(".tif"):
            os.remove(os.path.join(folder, old))
    digests = {}
    for name, data in sorted(cases().items()):
        path = os.path.join(folder, name)
        with open(path, "wb") as f:
            f.write(data)
        digests[name] = tc.reference(path)
    with tempfile.TemporaryDirectory() as tmp:
        for name, data in made().items():
            path = os.path.join(tmp, name)
            with open(path, "wb") as f:
                f.write(data)
            digests[name] = tc.reference(path)
    tc._dump(os.path.join(folder, DIGESTS),
             {k: digests[k] for k in sorted(digests)})
    with open(os.path.join(folder, TRANSFORM), "w") as f:
        json.dump({"pixels": "all 2^24 LAB pixels as Pillow stores them "
                             "(L, a + 128, b + 128), in the order of "
                             "their value",
                   "sha256": sha256(pillow_transform())}, f, indent=1)
        f.write("\n")
    return digests


def digest(img) -> str:
    return tj.digest(img)


if __name__ == "__main__":
    print(json.dumps(write(*sys.argv[1:]), indent=1, sort_keys=True))
