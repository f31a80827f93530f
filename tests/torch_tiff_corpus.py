"""The TIFF corpus (tests/fixtures/torch_tiff_corpus/): files the JAX package
hands to Pillow 12.1.0, whose TiffImagePlugin reads them (over libtiff 4.7.1
where the file is compressed), and which the port reads in data/tiff.py and
csrc/tiff_decode.cc.

Small files made from numpy seeds, from three sources:

- Pillow's writer: raw, ``packbits``, ``tiff_lzw``, ``tiff_deflate`` and
  ``tiff_adobe_deflate`` for every mode Pillow saves, Orientation 1-8
  through ``tiffinfo``, two pages through ``save_all``;
- tests/torch_tiff_writer.c over Pillow's libtiff: tiles, planar
  configuration 2, predictors 2 and 3, BigTIFF, fill order 2,
  min-is-white, 2- and 4-bit grey and palette, extra samples, partial last
  strips, big-endian 16- and 32-bit samples;
- written here (``Tiff``): old-style LZW, PackBits runs that end short,
  each mode of Pillow's ``OPEN_INFO`` table on the raw route, and the
  files Pillow or libtiff refuse or pass on.

``digests.json`` holds, for each file, the sha256 of each JAX route's
pixels on this machine, null where it fails: ``loader`` is the JAX server's
``_decode_image`` (Pillow on the file's bytes), ``load`` the loader's
``load_image_rgb(path)`` and ``img`` detect ``--img``'s
``Image.open(path).convert("RGB")`` (both open the path, so Pillow maps an
uncompressed single-strip file), and ``hw`` the (h, w) Pillow's open reads.
``scene_digests.json`` holds the same for the 640x480 scenes
(``scene_cases``), which are made at run time from
tests/torch_jpeg_fixtures.py:scene 0 with numpy alone (``Tiff`` and
``lzw``/``packbits`` here), so chip_smoke.py remakes them on the card.
Remake the corpus (Pillow, the JAX package, and g++ with the system's
tiffio.h for the writer) with

  python -m tests.torch_tiff_corpus [folder]

File names give the width before the height.
"""

import ctypes
import functools
import glob
import hashlib
import io
import json
import os
import struct
import subprocess
import sys
import zlib

import numpy as np

FOLDER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                      "torch_tiff_corpus")
DIGESTS = "digests.json"
SCENE_DIGESTS = "scene_digests.json"
WRITER_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "torch_tiff_writer.c")
WRITER_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "tests")

# tw_write's spec, in tests/torch_tiff_writer.c's order
SPEC = ("width", "height", "spp", "bps", "sampleformat", "photometric",
        "compression", "predictor", "planar", "fillorder", "rows_per_strip",
        "tile_width", "tile_height", "orientation", "bigtiff", "bigendian",
        "n_extra", "extra0", "extra1", "extra2", "sub_h", "sub_v",
        "jpegcolormode", "jpegtablesmode", "quality", "refbw", "coefficients",
        "positioning", "zstd_level", "lzma_preset", "t4options", "t6options")


def picture(seed: int, h: int, w: int, channels: int = 3,
            high: int = 256) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, high, (h, w, channels), np.int64)


# -- libtiff, through the tests' writer ----------------------------------------

def pillow_libtiff() -> str:
    """The libtiff Pillow bundles (pillow.libs/libtiff-*.so.6.2.0)."""
    import PIL

    found = glob.glob(os.path.join(os.path.dirname(os.path.dirname(
        PIL.__file__)), "pillow.libs", "libtiff-*.so.6.2.0"))
    if not found:
        raise RuntimeError("Pillow bundles no libtiff 4.7 here")
    return found[0]


@functools.cache
def _writer():
    """tests/torch_tiff_writer.c built against Pillow's libtiff into
    build/tests (named by a digest of the source and the library)."""
    lib_path = pillow_libtiff()
    with open(WRITER_SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read() + lib_path.encode()).hexdigest()[:16]
    path = os.path.join(WRITER_DIR, f"libtiff_writer_{tag}.so")
    if not os.path.isfile(path):
        os.makedirs(WRITER_DIR, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-o",
                        tmp, WRITER_SOURCE, lib_path,
                        f"-Wl,-rpath,{os.path.dirname(lib_path)}"],
                       check=True, capture_output=True)
        os.replace(tmp, path)
    from PIL import Image  # noqa: F401  (loads libtiff's own dependencies)

    lib = ctypes.CDLL(path)
    lib.tw_write.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_uint16),
                             ctypes.POINTER(ctypes.c_uint8),
                             ctypes.POINTER(ctypes.c_float)]
    lib.tw_write.restype = ctypes.c_int
    lib.tw_write_raw.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float)]
    lib.tw_write_raw.restype = ctypes.c_int
    return lib


def libtiff(samples: np.ndarray, bps: int = 8, *, colormap=None,
            raw=None, **spec) -> bytes:
    """A TIFF of samples ((h, w, spp) integers or floats) written by
    libtiff 4.7.1. spec: SPEC's fields (photometric, compression,
    predictor, planar, ...; defaults: min-is-black, uncompressed, one
    strip of 8 rows, contiguous, fill order 1); bps below 8 packs each
    row MSB first. raw: the strips or tiles (bytes each), written as they
    are; samples then give the sizes alone."""
    import tempfile

    samples = np.asarray(samples)
    h, w, spp = samples.shape
    cfg = dict(width=w, height=h, spp=spp, bps=bps, sampleformat=1,
               photometric=1, compression=1, predictor=1, planar=1,
               fillorder=1, rows_per_strip=8, tile_width=0, tile_height=0,
               orientation=0, bigtiff=0, bigendian=0, n_extra=0, extra0=0,
               extra1=0, extra2=0, sub_h=0, sub_v=0, jpegcolormode=0,
               jpegtablesmode=-1, quality=0, refbw=0, coefficients=0,
               positioning=0, zstd_level=0, lzma_preset=0, t4options=0,
               t6options=0)
    extra = spec.pop("extra", ())
    floats = np.zeros(9, np.float32)
    for key, at, n in (("refbw", 0, 6), ("coefficients", 6, 3)):
        if spec.get(key) is not None and spec.get(key) != 0:
            floats[at:at + n] = spec[key]
            spec[key] = 1
    if "subsampling" in spec:
        spec["sub_h"], spec["sub_v"] = spec.pop("subsampling")
    cfg.update(n_extra=len(extra), **{f"extra{i}": e
                                      for i, e in enumerate(extra)})
    cfg.update(spec)
    if samples.dtype.kind == "f":
        cfg["sampleformat"] = 3
    planes = [samples] if cfg["planar"] == 1 else \
        [samples[..., i:i + 1] for i in range(spp)]
    data = b"".join(pack_rows(p, bps) for p in planes)
    buf = np.frombuffer(data, np.uint8).copy()
    cmap = None
    if colormap is not None:
        cmap = np.ascontiguousarray(colormap, np.uint16)
    values = (ctypes.c_int * len(SPEC))(*[int(cfg[k]) for k in SPEC])
    u16p = ctypes.POINTER(ctypes.c_uint16)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    fp = ctypes.POINTER(ctypes.c_float)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "f.tif")
        if raw is not None:
            buf = np.frombuffer(b"".join(raw) or b"\0", np.uint8).copy()
            sizes = (ctypes.c_int64 * max(len(raw), 1))(
                *[len(c) for c in raw])
            rc = _writer().tw_write_raw(
                path.encode(), values,
                None if cmap is None else cmap.ctypes.data_as(u16p),
                buf.ctypes.data_as(u8p), sizes, len(raw),
                floats.ctypes.data_as(fp))
        else:
            rc = _writer().tw_write(
                path.encode(), values,
                None if cmap is None else cmap.ctypes.data_as(u16p),
                buf.ctypes.data_as(u8p), floats.ctypes.data_as(fp))
        if rc:
            raise ValueError(f"libtiff refused {cfg}")
        with open(path, "rb") as f:
            return f.read()


def pack_rows(samples: np.ndarray, bps: int) -> bytes:
    """(h, w, c) samples as rows of bps-bit samples, each row padded to a
    byte (MSB first at other widths; host order at 16 and 32)."""
    h, w, c = samples.shape
    if samples.dtype.kind == "f":
        return np.ascontiguousarray(samples, np.float32).tobytes()
    if bps in (8, 16, 32):
        dtype = {8: np.uint8, 16: np.uint16, 32: np.uint32}[bps]
        return np.ascontiguousarray(samples.astype(np.int64) %
                                    (1 << bps)).astype(dtype).tobytes()
    bits = (samples.reshape(h, w * c)[..., None].astype(np.int64) >>
            np.arange(bps - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, -1).astype(np.uint8),
                       axis=1).tobytes()


# -- written here: a TIFF from its tags, and the codecs, numpy only ----------

# the default type of each tag Tiff writes: LONG for sizes and offsets,
# SHORT for the rest
LONG_TAGS = (256, 257, 273, 278, 279, 322, 323, 324, 325)
TYPE_CODES = {1: "B", 3: "H", 4: "L", 6: "b", 8: "h", 9: "l", 13: "L",
              16: "Q", 17: "q", 11: "f", 12: "d"}
TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}
CHUNKS = "chunks"               # a tag value: the chunks' offsets or sizes


def chunks_in(*order) -> tuple:
    """A tag value: the offsets (or sizes) of the chunks in this order."""
    return (CHUNKS, order)


def tiff_file(tags, chunks=(), *, endian: str = "<", big: bool = False,
              ifd_last: bool = False, magic: bytes = None, sort: bool = True,
              first: int = None, pad: bytes = b"") -> bytes:
    """A TIFF of tags and data chunks. tags: {tag: value} or a list of
    (tag, value) or (tag, type, value, count) entries; a value is an int,
    a tuple of ints, bytes (BYTE, ASCII, UNDEFINED), or CHUNKS for the
    offsets (273, 324) or sizes (279, 325) of the chunks (chunks_in: of
    some of them, in another order). The IFD comes
    first (after pad) or after the chunks; magic overrides the first
    four bytes, first the IFD's offset."""
    entries = []
    for item in (tags.items() if isinstance(tags, dict) else tags):
        tag, rest = item[0], item[1:]
        if len(rest) == 1:
            value = rest[0]
            typ = 4 if tag in LONG_TAGS else 3
            if isinstance(value, bytes):
                typ = 7
            entries.append([tag, typ, value, None])
        else:
            entries.append([tag, rest[0], rest[1],
                            rest[2] if len(rest) > 2 else None])
    if sort:
        entries.sort(key=lambda e: e[0])
    bo = "<" if endian == "<" else ">"
    head = 16 if big else 8
    n_size, e_size, word = (8, 20, 8) if big else (2, 12, 4)
    ifd_size = n_size + len(entries) * e_size + word

    def pack(typ, value) -> bytes:
        if isinstance(value, bytes):
            return value
        values = value if isinstance(value, (tuple, list)) else (value,)
        if typ in (5, 10):
            return struct.pack(f"{bo}{len(values)}{'L' if typ == 5 else 'l'}",
                               *values)
        return struct.pack(f"{bo}{len(values)}{TYPE_CODES[typ]}", *values)

    def layout(chunk_at):
        extra, blobs = [], []
        for tag, typ, value, count in entries:
            if isinstance(value, tuple) and value[:1] == (CHUNKS,):
                value = tuple(chunk_at[i] if tag in (273, 324) else
                              len(chunks[i]) for i in value[1])
            elif value == CHUNKS:
                value = tuple(chunk_at) if tag in (273, 324) else \
                    tuple(len(c) for c in chunks)
            data = pack(typ, value)
            n = count if count is not None else len(data) // TYPE_SIZES[typ]
            blobs.append((tag, typ, n, data))
        return blobs

    # two passes: the out-of-line data's size does not depend on offsets
    sizes = layout([0] * len(chunks))
    out_of_line = sum(len(d) + (len(d) & 1) for *_, d in sizes
                      if len(d) > word)
    if ifd_last:
        at = head + len(pad)
        chunk_at = []
        for c in chunks:
            chunk_at.append(at)
            at += len(c)
        ifd_at = at + (at & 1)
    else:
        ifd_at = head + len(pad)
        at = ifd_at + ifd_size + out_of_line
        chunk_at = []
        for c in chunks:
            chunk_at.append(at)
            at += len(c)
    blobs = layout(chunk_at)
    ifd = bytearray(struct.pack(bo + ("Q" if big else "H"), len(blobs)))
    values = bytearray()
    values_at = ifd_at + ifd_size
    for tag, typ, n, data in blobs:
        ifd += struct.pack(bo + "HH", tag, typ)
        ifd += struct.pack(bo + ("Q" if big else "L"), n)
        if len(data) <= word:
            ifd += data.ljust(word, b"\0")
        else:
            ifd += struct.pack(bo + ("Q" if big else "L"),
                               values_at + len(values))
            values += data + b"\0" * (len(data) & 1)
    ifd += bytes(word)                               # no next IFD
    order = b"II" if bo == "<" else b"MM"
    if big:
        header = order + struct.pack(bo + "HHHQ", 43, 8, 0,
                                     ifd_at if first is None else first)
    else:
        header = order + struct.pack(bo + "HL", 42,
                                     ifd_at if first is None else first)
    if magic is not None:
        header = magic + header[4:]
    body = b"".join(chunks)
    if ifd_last:
        return header + pad + body + b"\0" * (len(body) & 1) + bytes(ifd) + \
            bytes(values)
    return header + pad + bytes(ifd) + bytes(values) + body


def patched(data: bytes, tag: int, value: int) -> bytes:
    """data with the value field of IFD0's entry for tag set to value (a
    classic little-endian file)."""
    data = bytearray(data)
    at = struct.unpack_from("<L", data, 4)[0]
    for i in range(struct.unpack_from("<H", data, at)[0]):
        entry = at + 2 + 12 * i
        if struct.unpack_from("<H", data, entry)[0] == tag:
            struct.pack_into("<L", data, entry + 8, value)
    return bytes(data)


def lzw(data: bytes, old: bool = False, clear_first: bool = True,
        eoi: bool = True) -> bytes:
    """TIFF LZW of data: MSB-first codes whose width grows one code early
    (libtiff's writer), or with old the LSB-first codes of the first
    libtiff releases, whose width grows on the table passing a width's
    largest code ("LZWDecodeCompat")."""
    table = {bytes([i]): i for i in range(256)}
    nxt, width = 258, 9
    out, acc, nacc = bytearray(), 0, 0

    def put(code):
        nonlocal acc, nacc
        if old:
            acc |= code << nacc
            nacc += width
            while nacc >= 8:
                out.append(acc & 255)
                acc >>= 8
                nacc -= 8
        else:
            acc = (acc << width) | code
            nacc += width
            while nacc >= 8:
                nacc -= 8
                out.append((acc >> nacc) & 255)
            acc &= (1 << nacc) - 1

    def grow():
        nonlocal width
        limit = (1 << width) + (1 if old else 0)
        if nxt >= limit and width < 12:
            width += 1

    if clear_first:
        put(256)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = nxt
        nxt += 1
        grow()
        w = bytes([c])
        if nxt >= 4093:
            put(256)
            table = {bytes([i]): i for i in range(256)}
            nxt, width = 258, 9
    if w:
        put(table[w])
        nxt += 1
        grow()
    if eoi:
        put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 255 if not old else acc & 255)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 2 to 128 equal bytes as -n+1, the rest as
    literals of up to 128 bytes."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n and
                                             data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def horizontal(rows: np.ndarray, stride: int) -> np.ndarray:
    """Predictor 2 of (h, n) samples of one width: each less the one
    stride before it in its row (wrapping)."""
    out = rows.copy()
    out[:, stride:] = rows[:, stride:] - rows[:, :-stride]
    return out


def strips(data: bytes, row: int, rows_per_strip: int) -> list:
    return [data[i:i + row * rows_per_strip]
            for i in range(0, len(data), row * rows_per_strip)]


def tags_for(w: int, h: int, spp: int, bps: int, photometric: int,
             compression: int = 1, rows_per_strip: int = None,
             more: dict = None):
    """The tags of a striped image (offsets and sizes from its chunks)."""
    tags = {256: w, 257: h, 258: (bps,) * spp if spp > 1 else bps,
            259: compression, 262: photometric, 273: CHUNKS, 277: spp,
            278: rows_per_strip or h, 279: CHUNKS}
    tags.update(more or {})
    return tags


# -- the corpus ---------------------------------------------------------------

def _pillow_saved(im, **kw) -> bytes:
    b = io.BytesIO()
    im.save(b, "TIFF", **kw)
    return b.getvalue()


PILLOW_CODECS = {"raw": None, "packbits": "packbits", "lzw": "tiff_lzw",
                 "deflate": "tiff_deflate",
                 "adobe_deflate": "tiff_adobe_deflate"}


def _pillow_cases(out: dict):
    """Pillow's writer: every mode it saves, each codec; Orientation 1-8;
    two pages."""
    from PIL import Image

    h, w = 13, 19
    rgba = picture(1, h, w, 4).astype(np.uint8)
    wide = picture(2, h, w, 1, 65536)[..., 0].astype(np.uint16)
    images = {
        "1": Image.fromarray(rgba[..., 0] > 127),
        "l": Image.fromarray(rgba[..., 0]),
        "la": Image.fromarray(rgba[..., :2], "LA"),
        "p": Image.fromarray(rgba[..., :3]).quantize(37),
        "pa": Image.fromarray(rgba[..., :3]).quantize(19).convert("PA"),
        "rgb": Image.fromarray(rgba[..., :3]),
        "rgba": Image.fromarray(rgba),
        "cmyk": Image.fromarray(rgba, "CMYK"),
        "i16": Image.fromarray(wide),
        "i16b": Image.fromarray(wide).convert("I;16B"),
        "i": Image.fromarray((wide.astype(np.int32) - 30000) // 50),
        "f": Image.fromarray((wide.astype(np.float32) - 30000) / 97.5),
    }
    for mode, im in images.items():
        for codec, name in PILLOW_CODECS.items():
            out[f"pw_{mode}_{codec}_{w}x{h}.tif"] = _pillow_saved(
                im, compression=name)
    rgb, grey = images["rgb"], images["l"]
    for o in range(1, 9):
        for codec in ("raw", "lzw"):
            out[f"pw_orient{o}_rgb_{codec}_{w}x{h}.tif"] = _pillow_saved(
                rgb, compression=PILLOW_CODECS[codec], tiffinfo={274: o})
        # one strip of L opened by its path is memory-mapped at the size
        # open reports
        out[f"pw_orient{o}_l_raw_{w}x{h}.tif"] = _pillow_saved(
            grey, tiffinfo={274: o})
    for codec in ("raw", "lzw"):
        out[f"pw_pages2_rgb_{codec}_{w}x{h}.tif"] = _pillow_saved(
            rgb, compression=PILLOW_CODECS[codec], save_all=True,
            append_images=[images["l"]])


def _libtiff_cases(out: dict):
    """tests/torch_tiff_writer.c over Pillow's libtiff."""
    h, w = 21, 37
    rgb = picture(3, h, w, 4)
    wide = picture(4, h, w, 4, 65536)
    flt = (np.random.default_rng(5).standard_normal((h, w, 1)) * 300
           ).astype(np.float32)
    cmap = picture(6, 1, 768, 1, 65536)[0, :, 0]
    codecs = {"raw": 1, "lzw": 5, "deflate": 8, "packbits": 32773}
    for codec, comp in codecs.items():
        for tw, th in ((16, 16), (32, 16)):
            out[f"lt_tiles{tw}x{th}_rgb_{codec}_{w}x{h}.tif"] = libtiff(
                rgb[..., :3], photometric=2, compression=comp,
                tile_width=tw, tile_height=th)
        out[f"lt_planar_rgb_{codec}_{w}x{h}.tif"] = libtiff(
            rgb[..., :3], photometric=2, compression=comp, planar=2,
            rows_per_strip=5)
        out[f"lt_partial_strips_rgb_{codec}_{w}x{h}.tif"] = libtiff(
            rgb[..., :3], photometric=2, compression=comp, rows_per_strip=6)
        out[f"lt_bigtiff_rgb_{codec}_{w}x{h}.tif"] = libtiff(
            rgb[..., :3], photometric=2, compression=comp, bigtiff=1)
        out[f"lt_be_i16_{codec}_{w}x{h}.tif"] = libtiff(
            wide[..., :1], 16, compression=comp, bigendian=1)
    for extra, name in (((2,), "rgba"), ((1,), "rgba_assoc"),
                        ((), "rgba_no_extra")):
        for codec in ("raw", "lzw"):
            out[f"lt_planar_{name}_{codec}_{w}x{h}.tif"] = libtiff(
                rgb, photometric=2, compression=codecs[codec], planar=2,
                extra=extra)
    for codec in ("raw", "lzw"):
        out[f"lt_planar_la_{codec}_{w}x{h}.tif"] = libtiff(
            rgb[..., :2], photometric=1, compression=codecs[codec],
            planar=2, extra=(2,))
        out[f"lt_planar_cmyk_{codec}_{w}x{h}.tif"] = libtiff(
            rgb, photometric=5, compression=codecs[codec], planar=2)
        out[f"lt_planar_rgbx_{codec}_{w}x{h}.tif"] = libtiff(
            rgb, photometric=2, compression=codecs[codec], planar=2,
            extra=(0,))
        out[f"lt_planar_rgb16_{codec}_{w}x{h}.tif"] = libtiff(
            wide[..., :3], 16, photometric=2, compression=codecs[codec],
            planar=2)
    out[f"lt_planar_tiles_rgbx_lzw_{w}x{h}.tif"] = libtiff(
        rgb, photometric=2, compression=5, planar=2, extra=(0,),
        tile_width=16, tile_height=16)
    out[f"lt_planar_tiles_rgb_deflate_{w}x{h}.tif"] = libtiff(
        rgb[..., :3], photometric=2, compression=8, planar=2,
        tile_width=16, tile_height=16)
    for comp, codec in ((5, "lzw"), (8, "deflate")):
        out[f"lt_pred2_rgb_{codec}_{w}x{h}.tif"] = libtiff(
            rgb[..., :3], photometric=2, compression=comp, predictor=2)
        out[f"lt_pred2_i16_{codec}_{w}x{h}.tif"] = libtiff(
            wide[..., :1], 16, compression=comp, predictor=2)
        out[f"lt_pred2_be_i16_{codec}_{w}x{h}.tif"] = libtiff(
            wide[..., :1], 16, compression=comp, predictor=2, bigendian=1)
        out[f"lt_pred2_rgb16_{codec}_{w}x{h}.tif"] = libtiff(
            wide[..., :3], 16, photometric=2, compression=comp, predictor=2)
        out[f"lt_pred2_i32_{codec}_{w}x{h}.tif"] = libtiff(
            wide[..., :1] * 65536 + wide[..., 1:2], 32, sampleformat=2,
            compression=comp, predictor=2)
        out[f"lt_pred3_f32_{codec}_{w}x{h}.tif"] = libtiff(
            flt, 32, compression=comp, predictor=3)
        out[f"lt_pred3_be_f32_{codec}_{w}x{h}.tif"] = libtiff(
            flt, 32, compression=comp, predictor=3, bigendian=1)
        out[f"lt_pred2_tiles_rgb_{codec}_{w}x{h}.tif"] = libtiff(
            rgb[..., :3], photometric=2, compression=comp, predictor=2,
            tile_width=16, tile_height=16)
        out[f"lt_pred2_planar_rgb_{codec}_{w}x{h}.tif"] = libtiff(
            rgb[..., :3], photometric=2, compression=comp, predictor=2,
            planar=2)
    for codec, comp in codecs.items():
        out[f"lt_fill2_1bit_{codec}_{w}x{h}.tif"] = libtiff(
            rgb[..., :1] % 2, 1, compression=comp, fillorder=2)
        out[f"lt_fill2_l_{codec}_{w}x{h}.tif"] = libtiff(
            rgb[..., :1], compression=comp, fillorder=2)
        for bps in (1, 2, 4, 8):
            out[f"lt_miniswhite{bps}_{codec}_{w}x{h}.tif"] = libtiff(
                rgb[..., :1] % (1 << bps), bps, photometric=0,
                compression=comp)
        for bps in (2, 4):
            out[f"lt_grey{bps}_{codec}_{w}x{h}.tif"] = libtiff(
                rgb[..., :1] % (1 << bps), bps, compression=comp)
            out[f"lt_palette{bps}_{codec}_{w}x{h}.tif"] = libtiff(
                rgb[..., :1] % (1 << bps), bps, photometric=3,
                compression=comp, colormap=cmap[:3 << bps])
    for codec in ("raw", "lzw"):
        comp = codecs[codec]
        out[f"lt_fill2_rgb_{codec}_{w}x{h}.tif"] = libtiff(
            rgb[..., :3], photometric=2, compression=comp, fillorder=2)
        out[f"lt_palette1_{codec}_{w}x{h}.tif"] = libtiff(
            rgb[..., :1] % 2, 1, photometric=3, compression=comp,
            colormap=cmap[:6])
        out[f"lt_grey12_{codec}_{w}x{h}.tif"] = libtiff(
            wide[..., :1] % 4096, 12, compression=comp)
        for extra, name in (((0,), "rgbx"), ((0, 0), "rgbxx"),
                            ((0, 0, 0), "rgbxxx"), ((1, 0), "rgbax_assoc"),
                            ((2, 0, 0), "rgbaxx"), ((1,), "rgba_assoc")):
            s = picture(7, h, w, 3 + len(extra))
            out[f"lt_extra_{name}_{codec}_{w}x{h}.tif"] = libtiff(
                s, photometric=2, compression=comp, extra=extra)
        out[f"lt_cmykx_{codec}_{w}x{h}.tif"] = libtiff(
            picture(8, h, w, 5), photometric=5, compression=comp,
            extra=(0,))
        out[f"lt_cmyk16_{codec}_{w}x{h}.tif"] = libtiff(
            wide, 16, photometric=5, compression=comp)
        out[f"lt_be_cmyk16_{codec}_{w}x{h}.tif"] = libtiff(
            wide, 16, photometric=5, compression=comp, bigendian=1)
        out[f"lt_rgba16_assoc_{codec}_{w}x{h}.tif"] = libtiff(
            wide, 16, photometric=2, compression=comp, extra=(1,))
        out[f"lt_be_rgbx16_{codec}_{w}x{h}.tif"] = libtiff(
            wide, 16, photometric=2, compression=comp, extra=(0,),
            bigendian=1)
        out[f"lt_be_i32s_{codec}_{w}x{h}.tif"] = libtiff(
            wide[..., :1] * 65536 - 2 ** 31, 32, sampleformat=2,
            compression=comp, bigendian=1)
        out[f"lt_i16s_{codec}_{w}x{h}.tif"] = libtiff(
            wide[..., :1] - 32768, 16, sampleformat=2, compression=comp)
        out[f"lt_u32_{codec}_{w}x{h}.tif"] = libtiff(
            wide[..., :1] * 65536 + wide[..., 1:2], 32, compression=comp)
        out[f"lt_be_f32_{codec}_{w}x{h}.tif"] = libtiff(
            flt, 32, photometric=0, compression=comp, bigendian=1)
        out[f"lt_orient6_tiles_rgb_{codec}_{w}x{h}.tif"] = libtiff(
            rgb[..., :3], photometric=2, compression=comp, orientation=6,
            tile_width=16, tile_height=16)
    # big-endian BigTIFF: Pillow reads its header as a classic one
    out[f"lt_be_bigtiff_rgb_lzw_{w}x{h}.tif"] = libtiff(
        rgb[..., :3], photometric=2, compression=5, bigtiff=1, bigendian=1)


def _hand_cases(out: dict):
    """Written here: old-style LZW, codec streams libtiff's writer never
    writes, and the rules of Pillow's open and libtiff's directory."""
    h, w = 5, 7
    rgb = picture(9, h, w, 3).astype(np.uint8)
    raw = rgb.tobytes()
    row = 3 * w
    base = tags_for(w, h, 3, 8, 2)

    def add(name, tags, chunks, **kw):
        out[f"hw_{name}_{w}x{h}.tif"] = tiff_file(tags, chunks, **kw)

    def lzw_tags(more=None):
        return {**base, 259: 5, **(more or {})}

    # LZW
    add("lzw_old", lzw_tags(), [lzw(raw, old=True)])
    add("lzw_old_strips", lzw_tags({278: 2}),
        [lzw(s, old=True) for s in strips(raw, row, 2)])
    pred = horizontal(rgb.reshape(h, row).astype(np.uint8), 3)
    add("lzw_old_pred2", lzw_tags({317: 2}), [lzw(pred.tobytes(), True)])
    add("lzw_old_then_new", lzw_tags({278: 2}),
        [lzw(s, old=i == 0) for i, s in enumerate(strips(raw, row, 2))])
    add("lzw_new_then_old", lzw_tags({278: 2}),
        [lzw(s, old=i > 0) for i, s in enumerate(strips(raw, row, 2))])
    add("lzw_no_clear", lzw_tags(), [lzw(raw, clear_first=False)])
    add("lzw_old_no_clear", lzw_tags(), [lzw(raw, old=True,
                                             clear_first=False)])
    add("lzw_no_eoi", lzw_tags(), [lzw(raw, eoi=False)])
    add("lzw_short", lzw_tags(), [lzw(raw[:-5])])
    add("lzw_old_short", lzw_tags(), [lzw(raw[:-5], old=True)])
    add("lzw_long", lzw_tags(), [lzw(raw + b"\x07" * 40)])
    add("lzw_old_long", lzw_tags(), [lzw(raw + b"\x07" * 40, old=True)])
    add("lzw_junk_after_eoi", lzw_tags(), [lzw(raw) + b"\xde\xad"])
    # the strip's byte count runs one byte past the end of the file, in
    # junk after the stream's EOI
    name = f"hw_lzw_count_past_end_{w}x{h}.tif"
    add("lzw_count_past_end", lzw_tags(), [lzw(raw) + b"\xde\xad"])
    out[name] = out[name][:-1]
    big = picture(11, 20, 40, 3).astype(np.uint8).tobytes()
    out["hw_lzw_old_wide_40x20.tif"] = tiff_file(
        tags_for(40, 20, 3, 8, 2, 5), [lzw(big, old=True)])
    add("lzw_cut_stream", lzw_tags(), [lzw(raw)[:-9]])
    add("lzw_one_byte_strip", lzw_tags({278: 1, 279: (1,) * 5,
                                          273: CHUNKS}),
        [b"\x80"] * 5)
    # PackBits
    pb = {**base, **{259: 32773}}
    add("packbits_short", pb, [packbits(raw[:-4])])
    add("packbits_long_run", pb, [packbits(raw[:-3]) + b"\xf0\x09"])
    add("packbits_long_literal", pb, [packbits(raw[:-3]) + b"\x05" +
                                      b"\x01" * 6])
    add("packbits_nop", pb, [b"\x80" + packbits(raw) + b"\x80"])
    add("packbits_run_cut", pb, [packbits(raw[:-3]) + b"\xfe"])
    add("packbits_literal_cut", pb, [packbits(raw[:-3]) + b"\x05\x01"])
    add("packbits_pred2_ignored", {**pb, **{317: 2}}, [packbits(raw)])
    # deflate
    dfl = {**base, **{259: 8}}
    add("deflate_short", dfl, [zlib.compress(raw[:-4])])
    add("deflate_long", dfl, [zlib.compress(raw + b"\x01" * 30)])
    add("deflate_bad_check", dfl, [zlib.compress(raw)[:-1] + b"\x00"])
    add("deflate_raw_stream", dfl, [zlib.compress(raw)[2:]])
    add("deflate_cut", dfl, [zlib.compress(raw)[:-6]])
    add("deflate_32946", {**base, **{259: 32946}}, [zlib.compress(raw)])
    # libtiff's directory
    add("missing_bytecounts_lzw", {k: v for k, v in lzw_tags().items()
                                   if k != 279}, [lzw(raw)])
    add("missing_bytecounts_lzw_strips",
        {k: v for k, v in lzw_tags({278: 2}).items() if k != 279},
        [lzw(s) for s in strips(raw, row, 2)])
    add("missing_bytecounts_raw", {k: v for k, v in base.items()
                                   if k != 279}, [raw])
    add("zero_bytecount_lzw", lzw_tags({279: 0}), [lzw(raw)])
    add("short_offsets_lzw", lzw_tags({278: 2, 273: (0,),
                                         279: (40, 40, 40)}),
        [lzw(s) for s in strips(raw, row, 2)])
    # PackBits from offset 0 (the header) decodes: zero padding shows
    add("short_offsets_packbits", {**pb, 278: 2, 273: (0,),
                                   279: (200, 200, 200)},
        [packbits(s) for s in strips(raw, row, 2)] + [bytes(200)])
    add("missing_offsets_lzw", {k: v for k, v in lzw_tags().items()
                                if k != 273}, [lzw(raw)])
    add("width_count2_raw", {**base, **{256: (w, w)}}, [raw])
    add("width_count2_lzw", lzw_tags({256: (w, w)}), [lzw(raw)])
    add("rps0_raw", {**base, **{278: 0}}, [raw])
    add("rps0_lzw", lzw_tags({278: 0}), [lzw(raw)])
    add("rps_huge_lzw", lzw_tags({278: 2 ** 31}), [lzw(raw)])
    add("planar3_raw", {**base, **{284: 3}}, [raw])
    add("planar3_lzw", lzw_tags({284: 3}), [lzw(raw)])
    add("pred2_4bit_lzw", tags_for(w, h, 1, 4, 1, 5, more={317: 2}),
        [lzw(bytes(4 * h))])
    add("pred5_lzw", lzw_tags({317: 5}), [lzw(raw)])
    add("pred3_int_lzw", lzw_tags({317: 3}), [lzw(raw)])
    add("pred_count2_lzw", lzw_tags({317: (2, 2)}), [lzw(raw)])
    add("bad_version_lzw", lzw_tags(), [lzw(raw)], magic=b"MM\x2a\x00",
        endian=">")
    add("bad_version_raw", base, [raw], magic=b"MM\x2a\x00", endian=">")
    add("bad_version_ii_raw", base, [raw], magic=b"II\x00\x2a")
    grey = rgb[..., 0]
    cm8 = tuple(range(0, 65536, 256)) * 3
    p8 = tags_for(w, h, 1, 8, 3, more={320: cm8})
    add("palette8_raw", p8, [grey.tobytes()])
    add("palette8_short_map_lzw", {**p8, **{259: 5, 320: cm8[:300]}},
        [lzw(grey.tobytes())])
    add("palette8_long_map_raw", {**p8, **{320: cm8 + (7,) * 3}},
        [grey.tobytes()])
    nib = ((grey % 16)[:, 0::2] << 4) | np.pad(grey % 16, ((0, 0), (0, 1)))[
        :, 1::2][:, :(w + 1) // 2]
    p4 = tags_for(w, h, 1, 4, 3, more={320: tuple(range(0, 65536, 4096)) * 3})
    add("palette4_raw", p4, [nib.astype(np.uint8).tobytes()])
    add("palette4_short_map_lzw", {**p4, **{259: 5,
                                              320: tuple(range(40))}},
        [lzw(nib.astype(np.uint8).tobytes())])
    add("palette4_short_map_raw", {**p4, **{320: tuple(range(40))}},
        [nib.astype(np.uint8).tobytes()])
    add("palette_no_map", tags_for(w, h, 1, 8, 3), [grey.tobytes()])
    # Pillow's open
    add("unknown_compression", {**base, **{259: 32766}}, [raw])
    add("pixarlog", {**base, **{259: 32909}}, [raw])
    for comp, name in ((2, "ccitt_rle"), (3, "group3"), (4, "group4"),
                       (7, "jpeg"), (6, "old_jpeg"), (34925, "lzma"),
                       (50000, "zstd"), (32809, "thunderscan"),
                       (34676, "sgilog"), (32771, "rle_16")):
        add(f"left_{name}", {**base, **{259: comp}}, [raw])
    add("left_ycbcr_raw", tags_for(w, h, 3, 8, 6), [raw])
    add("left_ycbcr_lzw", tags_for(w, h, 3, 8, 6, 5), [lzw(raw)])
    add("left_lab_raw", tags_for(w, h, 3, 8, 8), [raw])
    add("left_lab_lzw", tags_for(w, h, 3, 8, 8, 5), [lzw(raw)])
    add("left_ycbcr_grey", tags_for(w, h, 1, 8, 6), [grey.tobytes()])
    add("ifd_offset0", base, [raw], first=0)
    add("ifd_past_end", base, [raw], first=10 ** 6)
    add("ifd_offset_huge", base, [raw], first=2 ** 64 - 2, big=True)
    add("width0", {**base, **{256: 0}}, [raw])
    add("missing_length", {k: v for k, v in base.items() if k != 257},
        [raw])
    add("windows_media_photo", {**base, **{0xBC01: 1}}, [raw])
    add("spp7", tags_for(w, h, 7, 8, 2), [raw])
    add("unknown_mode", tags_for(w, h, 2, 8, 2), [raw])
    add("bps_count2_spp3", {**base, **{258: (8, 8)}}, [raw])
    add("bps_count4_spp3", {**base, **{258: (8, 8, 8, 16)}}, [raw])
    add("bps_count4_spp3_lzw", lzw_tags({258: (8, 8, 8, 16)}),
        [lzw(raw)])
    add("bps_one_spp3", {**base, **{258: 8}}, [raw])
    add("bps_one_spp3_lzw", lzw_tags({258: 8}), [lzw(raw)])
    add("sampleformat_111", {**base, **{339: (1, 1, 1)}}, [raw])
    add("sampleformat_0_lzw", lzw_tags({339: 0}), [lzw(raw)])
    add("bomb", {**base, **{256: 20000, 257: 20000}}, [raw])
    add("under_bomb", {**base, **{256: 10000, 257: 10000}}, [raw])
    add("byte_width", [(k, 1, bytes([v])) if k == 256 else (k, v)
                       for k, v in base.items()], [raw])
    add("rational_width", [(k, 5, (v, 1)) if k == 256 else (k, v)
                           for k, v in base.items()], [raw])
    add("ascii_compression_lzw", [(k, 2, b"LZW\0") if k == 259 else (k, v)
                                  for k, v in lzw_tags().items()],
        [lzw(raw)])
    add("ascii_compression_raw", [(k, 2, b"Uncompressed\0") if k == 259
                                  else (k, v) for k, v in base.items()],
        [raw])
    add("unknown_type_tag", list(base.items()) + [(999, 19, b"abcd", 1)],
        [raw])
    add("unknown_type_tag_lzw_estimate",
        [(k, v) for k, v in lzw_tags().items() if k != 279] +
        [(999, 19, b"abcd", 1)], [lzw(raw)])
    add("duplicate_width", list(base.items()) + [(256, w - 2)], [raw],
        sort=False)
    add("unsorted_tags", list(reversed(list(base.items()))), [raw],
        sort=False)
    add("orient_rational6", list(base.items()) + [(274, 5, (6, 1))], [raw])
    add("orient_count2", list(base.items()) + [(274, 3, (6, 1))], [raw])
    add("orient9", {**base, **{274: 9}}, [raw])
    add("orient_ascii", list(base.items()) + [(274, 2, b"6\0")], [raw])
    add("colormap_float", [(k, v) for k, v in tags_for(
        w, h, 1, 8, 3).items()] + [(320, 11, (0.5,) * 768)],
        [grey.tobytes()])
    # the raw route's tiles and strips
    add("raw_strips_unsorted", {**base, **{278: 2}},
        list(reversed(strips(raw, row, 2))))
    add("raw_short_offsets", {**base, **{278: 2, 273: CHUNKS}},
        strips(raw, row, 2)[:2])
    add("raw_extra_offsets", {**base, **{278: 5}}, [raw, raw[::-1]])
    # one strip covers the image: only the last offset, though it is not
    # the file's last chunk
    add("raw_extra_offsets_reversed", {**base, 278: 5,
                                       273: chunks_in(1, 0),
                                       279: chunks_in(1, 0)},
        [raw, raw[::-1]])
    # the strips twice over (offsets past the image's rows start again at
    # its top): tiles decode in file order, so the later chunks win
    twice = strips(raw, row, 2) + strips(raw[::-1], row, 2)
    add("raw_strips_twice", {**base, 278: 2, 273: chunks_in(3, 4, 5, 0, 1, 2),
                             279: chunks_in(3, 4, 5, 0, 1, 2)}, twice)
    add("raw_truncated", base, [raw[:-1]])
    add("raw_trailing", base, [raw + b"tail"])
    add("raw_planar_extra_offsets", {**base, **{284: 2, 278: 5}},
        [raw[i::3] for i in range(3)] + [raw[:35]])
    add("raw_planar_la", tags_for(w, h, 2, 8, 1, more={284: 2, 338: (2,)}),
        [raw[:35], raw[35:70]])
    add("raw_planar_i16", tags_for(w, h, 1, 16, 1, more={284: 2}),
        [raw[:70]])
    add("raw_planar_rgba_assoc", tags_for(w, h, 4, 8, 2, more={
        284: 2, 338: (1,)}), [raw[:35]] * 4)
    add("raw_planar_lab", tags_for(w, h, 3, 8, 8, more={284: 2}),
        [raw[:35]] * 3)
    tiled = {k: v for k, v in base.items() if k not in (273, 278, 279)}
    wide_tile = np.zeros((16, 16, 3), np.uint8)
    wide_tile[:h, :w] = rgb
    add("raw_tile_wider_than_image", {**tiled, 322: 16, 323: 16,
                                      324: CHUNKS, 325: CHUNKS},
        [wide_tile.tobytes()])
    add("raw_tile_cut_in_padding", {**tiled, 322: 16, 323: 16,
                                    324: CHUNKS, 325: CHUNKS},
        [wide_tile.tobytes()[:16 * 3 * (h - 1) + 3 * w]])
    add("raw_signed_offset", [(k, v) for k, v in base.items()
                              if k != 273] + [(273, 9, (-8,))], [raw])
    add("ifd_after_data_past_prefix",
        tags_for(300, 80, 3, 8, 2), [picture(10, 80, 300, 3).astype(
            np.uint8).tobytes()], ifd_last=True)
    add("ifd_after_data_lzw", lzw_tags(), [lzw(raw)], ifd_last=True)
    grey_tags = tags_for(w, h, 1, 8, 1)
    add("ifd_cut_before_next", grey_tags, [rgb[..., 0].tobytes()],
        ifd_last=True)
    name = f"hw_ifd_cut_before_next_{w}x{h}.tif"
    out[name] = out[name][:-4]
    add("ifd_cut_in_entries", base, [raw])
    name = f"hw_ifd_cut_in_entries_{w}x{h}.tif"
    data = out[name]
    out[name] = data[:8 + 2 + 12 * 6] + b"\0" * 0
    for codec, tags, chunk in (
            ("raw", base, raw), ("packbits", pb, packbits(raw)),
            ("lzw", lzw_tags(), lzw(raw)), ("deflate", dfl, zlib.compress(raw))):
        add(f"ifd_first_{codec}", tags, [chunk])
    # BitsPerSample's values past the end of the file: Pillow's read of the
    # directory stops there
    name = f"hw_bps_data_past_end_{w}x{h}.tif"
    add("bps_data_past_end", base, [raw])
    out[name] = patched(out[name], 258, 10 ** 6)
    # ImageDescription's text past the end: the read stops before the
    # strips' tags
    name = f"hw_description_past_end_{w}x{h}.tif"
    add("description_past_end", {**base, 270: b"a scanner's page\0"}, [raw])
    out[name] = patched(out[name], 270, 10 ** 6)
    add("be_raw", base, [raw], endian=">")
    add("be_lzw_bigtiff", lzw_tags(), [lzw(raw)], endian=">", big=True)
    add("bigtiff_bad_offset_size_lzw", lzw_tags(), [lzw(raw)], big=True)
    bad = out[f"hw_bigtiff_bad_offset_size_lzw_{w}x{h}.tif"]
    out[f"hw_bigtiff_bad_offset_size_lzw_{w}x{h}.tif"] = \
        bad[:4] + b"\x04" + bad[5:]


def _cut_cases(out: dict):
    """A few cuts of one file of each codec (every cut is tested live)."""
    for name in CUT_SOURCES:
        data = out[name]
        for frac in (0.3, 0.7, 0.95):
            cut = int(len(data) * frac)
            out[f"cut{cut}_" + name] = data[:cut]


CUT_SOURCES = ("pw_rgb_raw_19x13.tif", "pw_rgb_lzw_19x13.tif",
               "hw_ifd_first_packbits_7x5.tif", "hw_ifd_first_lzw_7x5.tif",
               "hw_ifd_first_deflate_7x5.tif")


def cases() -> dict:
    out = {}
    _pillow_cases(out)
    _libtiff_cases(out)
    _hand_cases(out)
    _cut_cases(out)
    return out


# -- generated at run time ----------------------------------------------------

def encode(rgb: np.ndarray, codec: str = "lzw", predictor: int = 1,
           rows_per_strip: int = 16, tile: int = 0, planar: bool = False,
           orientation: int = 0) -> bytes:
    """An (h, w, 3) uint8 image (or (h, w) uint16 grey) as a TIFF: codec
    "raw", "packbits", "lzw" or "deflate", predictor 1 or 2, strips of
    rows_per_strip rows or square tiles, planar or contiguous; numpy and
    zlib only."""
    grey = rgb.ndim == 2
    h, w = rgb.shape[:2]
    spp = 1 if grey else 3
    bps = 16 if grey else 8
    samples = rgb.reshape(h, w, spp)
    comp = {"raw": 1, "packbits": 32773, "lzw": 5, "deflate": 8}[codec]
    pack = {"raw": lambda b: b, "packbits": packbits, "lzw": lzw,
            "deflate": zlib.compress}[codec]

    def coded(rows: np.ndarray, stride: int) -> bytes:
        if predictor == 2:
            rows = horizontal(rows, stride)
        return pack(np.ascontiguousarray(rows).tobytes())

    tags = {256: w, 257: h, 258: (bps,) * spp if spp > 1 else bps,
            259: comp, 262: 1 if grey else 2, 277: spp}
    if predictor != 1:
        tags[317] = predictor
    if orientation:
        tags[274] = orientation
    chunks = []
    if tile:
        pad = np.zeros((-(-h // tile) * tile, -(-w // tile) * tile, spp),
                       samples.dtype)
        pad[:h, :w] = samples
        for y in range(0, h, tile):
            for x in range(0, w, tile):
                t = pad[y:y + tile, x:x + tile].reshape(tile, tile * spp)
                chunks.append(coded(t, spp))
        tags.update({322: tile, 323: tile, 324: CHUNKS, 325: CHUNKS})
        return tiff_file(tags, chunks)
    planes = [samples[..., c] for c in range(spp)] if planar else [
        samples.reshape(h, w * spp)]
    for plane in planes:
        for y in range(0, h, rows_per_strip):
            chunks.append(coded(plane[y:y + rows_per_strip],
                                1 if planar else spp))
    tags.update({273: CHUNKS, 278: rows_per_strip, 279: CHUNKS})
    if planar:
        tags[284] = 2
    return tiff_file(tags, chunks)


def scene_cases(rgb: np.ndarray) -> dict:
    """A 640x480 scene (tests/torch_jpeg_fixtures.py:scene 0) as TIFF:
    uncompressed, PackBits, LZW, LZW with predictor 2, deflate in 64x64
    tiles with predictor 2, planar (separate planes, uncompressed) and
    16-bit grey (the scene's grey, below 256, in 16 bits): numpy and zlib
    only, in 16-row strips."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    grey = (rgb.astype(np.int64).sum(-1) // 3).astype(np.uint16)
    return {
        "scene_raw_640x480.tif": encode(rgb, "raw"),
        "scene_packbits_640x480.tif": encode(rgb, "packbits"),
        "scene_lzw_640x480.tif": encode(rgb, "lzw"),
        "scene_lzw_pred2_640x480.tif": encode(rgb, "lzw", predictor=2),
        "scene_deflate_tiles_pred2_640x480.tif": encode(
            rgb, "deflate", predictor=2, tile=64),
        "scene_planar_640x480.tif": encode(rgb, "raw", planar=True),
        "scene_grey16_640x480.tif": encode(grey, "raw"),
    }


def reference(path: str) -> dict:
    """Each JAX route's pixels' sha256 (null where it fails) and the size
    Pillow's open reads: the server's _decode_image on the bytes, the
    loader's load_image_rgb and detect --img's Image.open on the path."""
    from PIL import Image

    from yolov5m_tpu.data import native as jax_native
    from yolov5m_tpu.data.dataset import _read_image_size
    from yolov5m_tpu.serving.server import _decode_image

    def attempt(fn, *args):
        try:
            return fn(*args)
        except Exception:
            return None

    def opened(p):
        with Image.open(p) as im:
            return np.asarray(im.convert("RGB"))

    def sha(img):
        return None if img is None else hashlib.sha256(
            np.ascontiguousarray(img).tobytes()).hexdigest()

    with open(path, "rb") as f:
        data = f.read()
    hw = attempt(_read_image_size, path)
    return {"loader": sha(_decode_image(data)),
            "load": sha(attempt(jax_native.load_image_rgb, path)),
            "img": sha(attempt(opened, path)),
            "hw": None if hw is None else list(hw)}


def load(folder: str = FOLDER, name: str = DIGESTS) -> dict:
    with open(os.path.join(folder, name)) as f:
        return json.load(f)


def _dump(path: str, digests: dict):
    with open(path, "w") as f:
        f.write("{\n" + ",\n".join(
            f" {json.dumps(k)}: {json.dumps(v, sort_keys=True)}"
            for k, v in digests.items()) + "\n}\n")


def write(folder: str = FOLDER) -> dict:
    """Write every case, digests.json and scene_digests.json into folder;
    returns the digests."""
    import tempfile
    import warnings

    from tests import torch_jpeg_fixtures

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
        digests[name] = reference(path)
    _dump(os.path.join(folder, DIGESTS), digests)
    scenes = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, data in sorted(scene_cases(
                torch_jpeg_fixtures.scene(0)).items()):
            path = os.path.join(tmp, name)
            with open(path, "wb") as f:
                f.write(data)
            scenes[name] = reference(path)
    _dump(os.path.join(folder, SCENE_DIGESTS), scenes)
    return digests


if __name__ == "__main__":
    print(json.dumps(write(*sys.argv[1:]), indent=1, sort_keys=True))
