"""The 12-bit JPEG and old-style JPEG TIFF corpus
(tests/fixtures/torch_tiff_ojpeg_corpus/): files the JAX package hands to
Pillow 12.1.0, whose TiffImagePlugin reads them over libtiff 4.7.1 (its
JPEG codec's 12-bit branch over libjpeg-turbo 3.1.3's jpeg12 API; its
old-style JPEG codec, tif_ojpeg.c, then TIFFRGBAImage for YCbCr), and
which the port reads in data/tiff.py and csrc/jpeg_decode.cc (mode 2 at
precision 12; the OJpeg class).

Small files made from numpy seeds, from three sources:

- tests/torch_tiff_writer.c over Pillow's libtiff: 12-bit grey JPEG
  (photometric 1, Compression 7), Pillow's ``I;16`` opened with rawmode
  ``I;12``, in strips and tiles, with and without JPEGTables, at several
  qualities, under Orientation 6;
- tests/torch_jpeg12_writer.c over Pillow's libjpeg-turbo: 12-bit streams
  libtiff's writer never makes (progressive, arithmetic, optimized,
  restart intervals, lossless at every predictor, a progressive stream
  cut after its DC scan), wrapped in strips here (``tiff_file``), and the
  12-bit layouts Pillow or libtiff refuse (RGB, big-endian, a precision
  that disagrees with BitsPerSample);
- old-style JPEG (Compression 6) written here, as libtiff cannot write
  it: the numpy encoder's streams (tests/torch_tiff_jpeg_corpus.py) split
  into a JPEGInterchangeFormat header (or a whole JFIF stream the strips
  point into) and strips of entropy-coded data, or into JPEGQTables,
  JPEGDCTables and JPEGACTables tags over bare strips; every
  subsampling, one and three samples, strips, tiles and planes, the
  tags that old writers got wrong (JPEGInterchangeFormat and the tables
  disagreeing, a subsampling tag that disagrees with the SOF, no
  photometric tag or an RGB one, no sample tags), strips missing, cut,
  too long or past the end of the file, the SOF markers libtiff takes and
  refuses, restart markers out of place;
- the 640x480 scene (tests/torch_jpeg_fixtures.py:scene 0) for
  chip_smoke.py's phase 9o: as 12-bit grey JPEG (the mean of its
  channels, as the JPEG corpus's grey scene, as 12-bit values 0-255,
  strips of libjpeg-turbo's streams: libtiff's
  12-bit writer spoils every strip after the first, which Pillow and the
  port then read alike), as old-style JPEG 2x2 through
  JPEGInterchangeFormat (also under Orientation 6) and from tables: the
  card has no encoder the port may rely on, so these are committed.

A 12-bit JPEG TIFF of odd width is left out of the corpus: libtiff packs
pairs of samples, so the last one of a row is never written, and Pillow
reads it from a buffer it never initialised.

``digests.json`` holds, for each file, each JAX route's pixels' sha256
(tests/torch_tiff_corpus.py:reference; null where the route fails) and
the size Pillow reads. Remake the corpus (Pillow, the JAX package, gcc
and g++ with the system's jpeglib.h and tiffio.h for the writers) with

  python -m tests.torch_tiff_ojpeg_corpus [folder]

File names give the width before the height.
"""

import ctypes
import functools
import glob
import hashlib
import json
import os
import struct
import subprocess
import sys

import numpy as np


def _sibling(name: str):
    """tests/{name}.py by its path (chip_smoke.py loads this module so: a
    package named "tests" elsewhere on sys.path must not shadow it)."""
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
                      "torch_tiff_ojpeg_corpus")
DIGESTS = "digests.json"
WRITER12_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "torch_jpeg12_writer.c")
# the scenes chip_smoke.py's phase 9o reads (their PPM twins are made there)
SCENES = ("scene_j12_grey_640x480.tif", "scene_oj_jif_22_640x480.tif",
          "scene_oj_tables_22_640x480.tif")
ROTATED = "scene_oj_jif_22_orient6_640x480.tif"
Q75 = [tj.quant(75), tj.quant(75, tj.CHROMA)]


# -- 12-bit streams: libjpeg-turbo's jpeg12 API through ctypes --------------

def _pillow_libjpeg() -> str:
    import PIL

    found = glob.glob(os.path.join(os.path.dirname(os.path.dirname(
        PIL.__file__)), "pillow.libs", "libjpeg-*.so*"))
    if not found:
        raise RuntimeError("Pillow bundles no libjpeg here")
    return found[0]


@functools.cache
def _writer12():
    """tests/torch_jpeg12_writer.c built against Pillow's libjpeg into
    build/tests (named by a digest of the source and the library)."""
    lib_path = _pillow_libjpeg()
    with open(WRITER12_SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read() + lib_path.encode()).hexdigest()[:16]
    path = os.path.join(tc.WRITER_DIR, f"jpeg12_writer_{tag}.so")
    if not os.path.isfile(path):
        os.makedirs(tc.WRITER_DIR, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        subprocess.run(["gcc", "-O2", "-fPIC", "-shared", "-o", tmp,
                        WRITER12_SOURCE, lib_path,
                        f"-Wl,-rpath,{os.path.dirname(lib_path)}"],
                       check=True, capture_output=True)
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    lib.j12_write.restype = ctypes.c_long
    lib.j12_write.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 9 + [
        ctypes.c_void_p, ctypes.c_long]
    return lib


def jpeg12(px: np.ndarray, quality: int = 75, progressive: bool = False,
           arith: bool = False, optimize: bool = False, restart: int = 0,
           lossless: int = 0, pt: int = 0) -> bytes:
    """A 12-bit grey JPEG stream of (h, w) samples 0-4095 written by
    libjpeg-turbo 3.1.3."""
    px = np.ascontiguousarray(px, np.int16)
    h, w = px.shape
    out = np.zeros(w * h * 4 + 4096, np.uint8)
    n = _writer12().j12_write(px.ctypes.data, w, h, quality,
                              int(progressive), int(arith), int(optimize),
                              restart, lossless, pt, out.ctypes.data,
                              len(out))
    if n < 0:
        raise ValueError("libjpeg refused the 12-bit stream")
    return out[:n].tobytes()


def tiff12(px: np.ndarray, rows_per_strip: int = 0, tags=None, drop=(),
           mutate=None, endian: str = "<", **opts) -> bytes:
    """A 12-bit grey JPEG TIFF of (h, w) samples: each strip a whole
    12-bit stream (jpeg12's opts). mutate(k, stream) changes strip k's."""
    h, w = px.shape
    rps = rows_per_strip or h
    chunks = [jpeg12(px[y:y + rps], **opts) for y in range(0, h, rps)]
    if mutate is not None:
        chunks = [mutate(k, c) for k, c in enumerate(chunks)]
    out = {256: w, 257: h, 258: 12, 259: 7, 262: 1, 277: 1,
           273: tc.CHUNKS, 278: rps, 279: tc.CHUNKS}
    out.update(tags or {})
    for t in drop:
        out.pop(t, None)
    return tc.tiff_file(tj._entries(out), chunks, endian=endian)


def dark12(seed: int, h: int, w: int) -> np.ndarray:
    """12-bit grey samples mostly below 256 (what convert("RGB") keeps),
    with some brighter: (h, w) int64."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 7 + yy * 5) % 240 + rng.integers(0, 24, (h, w))
    bright = rng.random((h, w)) < 0.05
    return np.where(bright, rng.integers(256, 4096, (h, w)), base)


def _lw12(px: np.ndarray, **spec) -> bytes:
    """A 12-bit grey JPEG TIFF written by libtiff."""
    spec.setdefault("compression", 7)
    spec.setdefault("rows_per_strip", 8)
    return tc.libtiff(np.asarray(px, np.uint16)[..., None], 12, **spec)


def _cut_after_first_scan(stream: bytes) -> bytes:
    """A progressive stream cut before its second SOS, closed with EOI."""
    first = stream.find(b"\xff\xda")
    second = stream.find(b"\xff\xda", first + 2)
    return stream[:second] + b"\xff\xd9"


def without_dht(stream: bytes) -> bytes:
    """stream without its DHT segments (before the first SOS)."""
    out, i = bytearray(stream[:2]), 2
    while stream[i + 1] != 0xDA:
        n = struct.unpack_from(">H", stream, i + 2)[0]
        if stream[i + 1] != 0xC4:
            out += stream[i:i + 2 + n]
        i += 2 + n
    return bytes(out + stream[i:])


def dqt16(stream: bytes, dc: int) -> bytes:
    """stream with its first DQT segment's tables written at 16 bits (Pq
    1), each one's DC quantizer set to dc."""
    at = stream.find(b"\xff\xdb")
    n = struct.unpack_from(">H", stream, at + 2)[0]
    body, tables, k = stream[at + 4:at + 2 + n], b"", 0
    while k < len(body):
        pq, tq = body[k] >> 4, body[k] & 15
        size = 128 if pq else 64
        values = list(struct.unpack_from(">64H" if pq else "64B", body,
                                         k + 1))
        values[0] = dc
        tables += bytes([0x10 | tq]) + struct.pack(">64H", *values)
        k += 1 + size
    return stream[:at] + tj._segment(0xDB, tables) + stream[at + 2 + n:]


def _j12_cases(out: dict):
    dark = dark12(1, 29, 38)
    for q in (10, 50, 75, 95, 100):
        out[f"lw12_grey_q{q}_38x29.tif"] = _lw12(dark, quality=q)
    out["lw12_grey_tables_off_38x29.tif"] = _lw12(dark, jpegtablesmode=0)
    out["lw12_grey_one_strip_38x29.tif"] = _lw12(dark, rows_per_strip=29)
    out["lw12_grey_tiles16_48x40.tif"] = _lw12(
        dark12(2, 40, 48), tile_width=16, tile_height=16)
    out["lw12_grey_tiles16_tables_off_48x40.tif"] = _lw12(
        dark12(2, 40, 48), tile_width=16, tile_height=16, jpegtablesmode=0)
    rng = np.random.default_rng(3)
    out["lw12_grey_noise_32x24.tif"] = _lw12(rng.integers(0, 4096, (24, 32)))
    grad = np.add.outer(np.arange(16), np.arange(64)) * 4095 // 78
    out["lw12_grey_gradient_64x16.tif"] = _lw12(grad, quality=90)
    out["lw12_grey_orient6_38x29.tif"] = _lw12(dark, orientation=6)
    px = dark12(4, 29, 38)
    for name, opts in (("baseline", {}), ("progressive",
                                          {"progressive": True}),
                       ("arith", {"arith": True}),
                       ("arith_progressive", {"arith": True,
                                              "progressive": True}),
                       ("optimized", {"optimize": True}),
                       ("restart1", {"restart": 1}),
                       ("q100_progressive", {"quality": 100,
                                             "progressive": True})):
        out[f"hm12_{name}_38x29.tif"] = tiff12(px, **opts)
    out["hm12_progressive_rps8_38x29.tif"] = tiff12(px, 8, progressive=True)
    for p in range(1, 8):
        out[f"hm12_lossless_p{p}_38x29.tif"] = tiff12(px, lossless=p)
    out["hm12_lossless_p1_pt3_38x29.tif"] = tiff12(px, lossless=1, pt=3)
    out["hm12_lossless_p6_rps8_restart_row_38x29.tif"] = tiff12(
        px, 8, lossless=6, restart=38)
    # no Huffman tables: a sequential frame takes libjpeg's standard ones,
    # a lossless frame none
    out["hm12_baseline_no_dht_38x29.tif"] = tiff12(
        px, mutate=lambda k, s: without_dht(s))
    out["hm12_lossless_p1_no_dht_38x29.tif"] = tiff12(
        px, lossless=1, mutate=lambda k, s: without_dht(s))
    out["hm12_progressive_dc_only_38x29.tif"] = tiff12(
        px, progressive=True, mutate=lambda k, s: _cut_after_first_scan(s))
    # a DC quantizer that takes the IDCT's sums past the range-limit
    # table's 14 bits, where they wrap
    out["hm12_dqt16_dc_huge_38x29.tif"] = tiff12(
        px, mutate=lambda k, s: dqt16(s, 40000))
    out["hm12_dqt16_dc_big_38x29.tif"] = tiff12(
        px, mutate=lambda k, s: dqt16(s, 700))
    out["hm12_strip1_cut_38x29.tif"] = tiff12(
        px, 8, mutate=lambda k, s: s[:len(s) // 2] if k == 1 else s)
    # refused: a 12-bit stream in an 8-bit file and the reverse; layouts
    # Pillow's OPEN_INFO has no key for (RGB, big-endian)
    out["hm12_stream12_bps8_38x29.tif"] = tiff12(px, tags={258: 8})
    out["hm12_stream8_bps12_38x29.tif"] = tc.tiff_file(tj._entries(
        {256: 38, 257: 29, 258: 12, 259: 7, 262: 1, 277: 1, 273: tc.CHUNKS,
         278: 29, 279: tc.CHUNKS}), [tj.encode_planes(
             [np.clip(px, 0, 255).astype(np.uint8)], [(1, 1)], Q75[:1], [0])])
    out["hm12_rgb_38x29.tif"] = tiff12(px, tags={262: 2, 277: 3,
                                                 258: (12, 12, 12)})
    out["hm12_bigendian_38x29.tif"] = tiff12(px, endian=">")


# -- old-style JPEG ----------------------------------------------------------

def split_stream(stream: bytes):
    """A JPEG stream's header (SOI to the end of the SOS segment) and its
    entropy-coded segments, split at the RST markers (EOI dropped)."""
    i = 2
    while True:
        marker = stream[i + 1]
        i += 2 + struct.unpack_from(">H", stream, i + 2)[0]
        if marker == 0xDA:
            break
    head, data = stream[:i], stream[i:]
    if data.endswith(b"\xff\xd9"):
        data = data[:-2]
    segments, cur, k = [], bytearray(), 0
    while k < len(data):
        if data[k] == 0xFF and k + 1 < len(data) and \
                0xD0 <= data[k + 1] <= 0xD7:
            segments.append(bytes(cur))
            cur = bytearray()
            k += 2
            continue
        cur.append(data[k])
        k += 1
    segments.append(bytes(cur))
    return head, segments


def ycc_planes(rgb: np.ndarray, sub) -> list:
    """YCbCr planes of (h, w, 3) RGB, the chroma downsampled by sub."""
    ycc = tj.ycbcr(rgb)
    return [ycc[..., 0]] + [tj.downsample(ycc[..., i], *sub)
                            for i in (1, 2)]


def ojpeg_file(rgb: np.ndarray, sub=(2, 2), rows_per_strip: int = 0,
               mode: str = "jif", grey: bool = False, quality: int = 75,
               tags=None, drop=(), ids=None, sof=None, mutate=None,
               endian: str = "<") -> bytes:
    """An old-style JPEG TIFF of (h, w, 3) RGB (grey: its first channel,
    one sample): one stream of the whole image (restart markers at each
    strip where there are several), its entropy data cut into the strips.
    mode "jif": the header at JPEGInterchangeFormat; "whole": the whole
    stream there, the strips pointing into it; "tables": the JPEGQTables,
    JPEGDCTables and JPEGACTables tags; "strip0": the header at the start
    of strip 0. sof: the SOF marker; mutate(k, segment) changes strip
    k's data; tags override or add tags (a value, or (type, value,
    count) of tj.typed), drop removes them."""
    h, w = rgb.shape[:2]
    rps = rows_per_strip or h
    if grey:
        planes, sampling, tq = [rgb[..., 0]], [(1, 1)], [0]
    else:
        planes = ycc_planes(rgb, sub)
        sampling, tq = [tuple(sub), (1, 1), (1, 1)], [0, 1, 1]
    n = len(planes)
    restart = 0
    if rps < h:
        restart = -(-w // (8 * sampling[0][0])) * (rps // (8 * sampling[0][1]))
    stream = tj.encode_planes(planes, sampling, Q75, tq,
                              ids=ids or list(range(n)), restart=restart,
                              height=h, width=w)
    if sof is not None:
        at = stream.find(b"\xff\xc0")
        stream = stream[:at + 1] + bytes([sof]) + stream[at + 2:]
    head, segments = split_stream(stream)
    if mutate is not None:
        segments = [mutate(k, s) for k, s in enumerate(segments)]
    out = {256: w, 257: h, 258: (8,) * n if n > 1 else 8, 259: 6,
           262: 6 if n == 3 else 1, 277: n, 278: rps}
    if n == 3:
        out[530] = tuple(sub)
    base = 8
    if mode == "whole":
        body = head + b"".join(s + bytes([0xFF, 0xD0 + k % 8])
                               for k, s in enumerate(segments[:-1])) + \
            segments[-1] + b"\xff\xd9"
        offsets, at = [], len(head)
        for s in segments:
            offsets.append(base + at)
            at += len(s) + 2
        chunks = [body]
        out.update({513: tj.typed(4, base), 514: tj.typed(4, len(body)),
                    273: tj.typed(4, tuple(offsets)),
                    279: tj.typed(4, tuple(len(s) for s in segments))})
    else:
        chunks = [head] if mode in ("jif", "tables") else []
        if mode == "strip0":
            segments = [head + segments[0]] + segments[1:]
        first = len(chunks)
        chunks += segments
        index = list(range(first, len(chunks)))
        out.update({273: tc.chunks_in(*index), 279: tc.chunks_in(*index)})
        if mode == "jif":
            out.update({513: tj.typed(4, base), 514: tj.typed(4, len(head))})
        if mode == "tables":
            at = base + sum(len(c) for c in chunks)
            tables, offs = _ojpeg_tables(n, at)
            chunks.append(tables)
            out.update({512: 1, 519: tj.typed(4, offs[0]),
                        520: tj.typed(4, offs[1]), 521: tj.typed(4, offs[2])})
    out.update(tags or {})
    for t in drop:
        out.pop(t, None)
    return tc.tiff_file(tj._entries(out), chunks, ifd_last=True,
                        endian=endian)


def _ojpeg_tables(n: int, at: int, quality: int = 75):
    """The bytes of JPEGQTables (zigzag), JPEGDCTables and JPEGACTables
    (16 counts, then values) of n components (the first luma, the others
    chroma) placed at file offset at, and their offsets."""
    qs = [tj.quant(quality), tj.quant(quality, tj.CHROMA)]
    blob = b""
    offs = ([], [], [])
    for ci in range(n):
        offs[0].append(at + len(blob))
        blob += bytes(int(qs[min(ci, 1)][z]) for z in tj.ZIGZAG)
    for kind in (0, 1):
        for ci in range(n):
            bits, vals = tj.STD_TABLES[2 * min(ci, 1) + kind]
            offs[1 + kind].append(at + len(blob))
            blob += bytes(bits) + vals
    return blob, tuple(tuple(o) for o in offs)


def _strip_values(data: bytes, tag: int, k: int, value: int) -> bytes:
    """data (a little-endian file) with value k of tag's out-of-line LONG
    array (or its inline value) set to value."""
    data = bytearray(data)
    at = struct.unpack_from("<L", data, 4)[0]
    for i in range(struct.unpack_from("<H", data, at)[0]):
        entry = at + 2 + 12 * i
        t, typ, count, val = struct.unpack_from("<HHLL", data, entry)
        if t == tag:
            where = entry + 8 if count == 1 else val + 4 * k
            struct.pack_into("<L", data, where, value)
    return bytes(data)


def tiled_ojpeg(rgb: np.ndarray, sub=(2, 2), tile: int = 16,
                short_frame: bool = False) -> bytes:
    """Old-style JPEG in tiles as libtiff reads them: one frame a tile
    wide, the tiles stacked in their order, each a restart interval.
    short_frame: the SOF's height only the tiles down (libtiff's frame),
    so that the tiles past it read what libjpeg last left."""
    h, w = rgb.shape[:2]
    across, down = -(-w // tile), -(-h // tile)
    tiles = []
    for ty in range(down):
        for tx in range(across):
            t = np.zeros((tile, tile, 3), np.uint8)
            part = rgb[ty * tile:(ty + 1) * tile, tx * tile:(tx + 1) * tile]
            t[:part.shape[0], :part.shape[1]] = part
            tiles.append(t)
    tall = np.concatenate(tiles, 0)
    restart = (tile // (8 * sub[0])) * (tile // (8 * sub[1]))
    stream = tj.encode_planes(
        ycc_planes(tall, sub), [tuple(sub), (1, 1), (1, 1)], Q75, [0, 1, 1],
        ids=[0, 1, 2], restart=restart,
        height=down * tile if short_frame else tall.shape[0], width=tile)
    head, segments = split_stream(stream)
    index = list(range(1, len(segments) + 1))
    index += [index[-1]] * (across * down - len(index))
    out = {256: w, 257: h, 258: (8, 8, 8), 259: 6, 262: 6, 277: 3,
           322: tile, 323: tile, 530: tuple(sub),
           324: tc.chunks_in(*index), 325: tc.chunks_in(*index),
           513: tj.typed(4, 8), 514: tj.typed(4, len(head))}
    return tc.tiff_file(tj._entries(out), [head] + segments, ifd_last=True)


def planar_ojpeg(rgb: np.ndarray, one_strip: bool = False,
                 header_only: bool = False) -> bytes:
    """Old-style JPEG in three planes: one JFIF stream of three scans at
    JPEGInterchangeFormat (only the first scan's header where
    header_only), a strip a plane pointing at each scan's data (one strip
    over all of them where one_strip: libtiff then takes the planes as
    contiguous)."""
    h, w = rgb.shape[:2]
    ycc = tj.ycbcr(rgb)
    scans = [split_stream(tj.encode_planes(
        [ycc[..., i]], [(1, 1)], Q75, [min(i, 1)], ids=[i + 1], height=h,
        width=w))[1][0] for i in range(3)]

    def sos(i):
        return tj._segment(0xDA, bytes([1, i + 1, 0 if i == 0 else 0x11, 0,
                                        63, 0]))
    sof = tj._segment(0xC0, struct.pack(">BHHB", 8, h, w, 3) + b"".join(
        struct.pack(">BBB", i + 1, 0x11, min(i, 1)) for i in range(3)))
    jif = b"\xff\xd8" + tj.table_segments(Q75) + sof + sos(0)
    body = jif + scans[0] + sos(1) + scans[1] + sos(2) + scans[2] + \
        b"\xff\xd9"
    offsets, at = [], 8 + len(jif)
    for i, s in enumerate(scans):
        offsets.append(at)
        at += len(s) + (len(sos(i + 1)) if i < 2 else 0)
    out = {256: w, 257: h, 258: (8, 8, 8), 259: 6, 262: 6, 277: 3, 284: 2,
           278: h, 530: (1, 1), 513: tj.typed(4, 8),
           514: tj.typed(4, len(jif) if header_only else len(body))}
    if one_strip:
        out.update({273: tj.typed(4, offsets[0]),
                    279: tj.typed(4, len(body) - len(jif))})
    else:
        out.update({273: tj.typed(4, tuple(offsets)),
                    279: tj.typed(4, tuple(len(s) for s in scans))})
    return tc.tiff_file(tj._entries(out), [body], ifd_last=True)


def _oj_cases(out: dict):
    rgb = tj.picture(11, 48, 64)
    subs = {"11": (1, 1), "21": (2, 1), "12": (1, 2), "22": (2, 2),
            "41": (4, 1), "42": (4, 2), "44": (4, 4)}
    for mode in ("jif", "tables"):
        for key, sub in subs.items():
            w = 64 if key == "44" else 40
            out[f"oj_{mode}_{key}_{w}x32.tif"] = ojpeg_file(
                rgb[:32, :w], sub, mode=mode)
        out[f"oj_{mode}_22_rps16_40x48.tif"] = ojpeg_file(
            rgb[:48, :40], (2, 2), 16, mode=mode)
        out[f"oj_{mode}_11_rps8_24x24.tif"] = ojpeg_file(
            rgb[:24, :24], (1, 1), 8, mode=mode)
        out[f"oj_{mode}_22_19x13.tif"] = ojpeg_file(rgb[:13, :19], mode=mode)
        out[f"oj_{mode}_21_7x5.tif"] = ojpeg_file(rgb[:5, :7], (2, 1),
                                                  mode=mode)
        out[f"oj_{mode}_grey_rps8_24x24.tif"] = ojpeg_file(
            rgb[:24, :24], rows_per_strip=8, mode=mode, grey=True)
    pic = rgb[:32, :40]
    out["oj_whole_22_40x32.tif"] = ojpeg_file(pic, mode="whole")
    out["oj_whole_22_rps16_40x48.tif"] = ojpeg_file(rgb[:48, :40], (2, 2),
                                                    16, mode="whole")
    out["oj_whole_22_jif_length0_40x32.tif"] = ojpeg_file(
        pic, mode="whole", tags={514: tj.typed(4, 0)})
    out["oj_strip0_header_22_40x32.tif"] = ojpeg_file(pic, mode="strip0")
    out["oj_strip0_header_22_rps16_40x48.tif"] = ojpeg_file(
        rgb[:48, :40], (2, 2), 16, mode="strip0")
    # JPEGInterchangeFormat and the tables tags disagree: the stream wins;
    # a JPEGInterchangeFormat into the entropy data or past the end: the
    # tables
    out["oj_tables_and_jif_disagree_40x32.tif"] = ojpeg_file(
        pic, mode="jif", tags={512: 1, 519: tj.typed(4, (8, 8, 8)),
                               520: tj.typed(4, (9, 9, 9)),
                               521: tj.typed(4, (10, 10, 10))})
    out["oj_tables_jif_into_data_40x32.tif"] = ojpeg_file(
        pic, mode="tables",
        tags={513: tj.typed(4, 8 + 3), 514: tj.typed(4, 20)})
    out["oj_tables_jif_past_eof_40x32.tif"] = ojpeg_file(
        pic, mode="tables", tags={513: tj.typed(4, 10 ** 6)})
    q, dc, _ = _tables_offsets(pic)
    out["oj_tables_one_q_40x32.tif"] = ojpeg_file(
        pic, mode="tables", tags={519: tj.typed(4, q[:1])})
    out["oj_tables_shared_q_40x32.tif"] = ojpeg_file(
        pic, mode="tables", tags={519: tj.typed(4, (q[0], q[0], q[0]))})
    out["oj_tables_q_repeated_40x32.tif"] = ojpeg_file(
        pic, mode="tables", tags={519: tj.typed(4, (q[0], q[1], q[0]))})
    out["oj_tables_q_count4_40x32.tif"] = ojpeg_file(
        pic, mode="tables", tags={519: tj.typed(4, q + (q[0],))})
    out["oj_tables_no_dc_40x32.tif"] = ojpeg_file(pic, mode="tables",
                                                  drop=(520,))
    out["oj_tables_dc_past_eof_40x32.tif"] = ojpeg_file(
        pic, mode="tables", tags={520: tj.typed(4, (10 ** 6,) + dc[1:])})
    out["oj_tables_restart_tag_40x32.tif"] = ojpeg_file(
        pic, mode="tables", tags={515: tj.typed(3, 2)})
    out["oj_tables_sub_tag21_40x32.tif"] = ojpeg_file(
        pic, mode="tables", tags={530: (2, 1)})
    out["oj_jif_sub_tag21_stream22_40x32.tif"] = ojpeg_file(
        pic, mode="jif", tags={530: (2, 1)})
    out["oj_jif_sub_tag44_stream22_40x32.tif"] = ojpeg_file(
        pic, mode="jif", tags={530: (4, 4)})
    out["oj_tables_sub_tag20_40x32.tif"] = ojpeg_file(
        pic, mode="tables", tags={530: (2, 0)})
    # packed YCbCr (not old-style JPEG) with a zero subsampling: libtiff's
    # scanline size is 0, so its directory fails
    out["yc_lzw_sub20_19x13.tif"] = tj.ycbcr_file(
        tj.ycbcr(rgb[:13, :19]), (2, 2), tags={530: (2, 0)})
    out["oj_jif_no_sub_tag_21_40x32.tif"] = ojpeg_file(
        pic, (2, 1), mode="jif", drop=(530,))
    for mode in ("jif", "tables"):
        out[f"oj_{mode}_no_photometric_40x32.tif"] = ojpeg_file(
            pic, mode=mode, drop=(262,))
        out[f"oj_{mode}_photometric_rgb_40x32.tif"] = ojpeg_file(
            pic, mode=mode, tags={262: 2})
        out[f"oj_{mode}_no_sample_tags_40x32.tif"] = ojpeg_file(
            pic, mode=mode, drop=(258, 277))
        out[f"oj_{mode}_no_spp_tag_40x32.tif"] = ojpeg_file(
            pic, mode=mode, drop=(277,))
        out[f"oj_{mode}_orient6_40x32.tif"] = ojpeg_file(
            pic, mode=mode, tags={274: 6})
    out["oj_jif_bigendian_40x32.tif"] = ojpeg_file(pic, mode="jif",
                                                   endian=">")
    out["oj_jif_ids_123_40x32.tif"] = ojpeg_file(pic, mode="jif",
                                                 ids=[1, 2, 3])
    out["oj_jif_sof1_40x32.tif"] = ojpeg_file(pic, mode="jif", sof=0xC1)
    out["oj_jif_sof2_40x32.tif"] = ojpeg_file(pic, mode="jif", sof=0xC2)
    out["oj_jif_sof3_40x32.tif"] = ojpeg_file(pic, mode="jif", sof=0xC3)
    # the SOF's sampling: libjpeg upsamples inside where it is not libtiff's
    for name, sampling in (("y11_cb11_cr21", [(1, 1), (1, 1), (2, 1)]),
                           ("y21_cb11_cr11", [(2, 1), (1, 1), (1, 1)]),
                           ("y22_cb22_cr22", [(2, 2), (2, 2), (2, 2)]),
                           ("y31_cb11_cr11", [(3, 1), (1, 1), (1, 1)])):
        out[f"oj_jif_sof_{name}_32x24.tif"] = _sampled_jif(rgb[:24, :32],
                                                           sampling)
    out["oj_jif_grey_comp22_24x24.tif"] = _sampled_jif(rgb[:24, :24],
                                                       [(2, 2)], grey=True)
    out["oj_jif_grey_minwhite_24x24.tif"] = ojpeg_file(
        rgb[:24, :24], mode="jif", grey=True, tags={262: 0})
    out["oj_jif_grey_orient6_24x24.tif"] = ojpeg_file(
        rgb[:24, :24], mode="jif", grey=True, tags={274: 6})
    # a JIF header with its own DRI, APPn and COM markers
    out["oj_jif_app_com_dri_40x48.tif"] = _jif_with_markers(rgb[:48, :40])
    # tiles and planes
    out["oj_tiled16_22_50x40.tif"] = tiled_ojpeg(rgb[:40, :50])
    out["oj_tiled16_11_50x40.tif"] = tiled_ojpeg(rgb[:40, :50], (1, 1))
    out["oj_tiled16_42_50x40.tif"] = tiled_ojpeg(rgb[:40, :50], (4, 2))
    out["oj_tiled32_22_50x40.tif"] = tiled_ojpeg(rgb[:40, :50], tile=32)
    out["oj_tiled32_44_50x40.tif"] = tiled_ojpeg(rgb[:40, :50], (4, 4), 32)
    out["oj_tiled16_22_short_frame_50x40.tif"] = tiled_ojpeg(
        rgb[:40, :50], short_frame=True)
    out["oj_planar_32x24.tif"] = planar_ojpeg(rgb[:24, :32])
    out["oj_planar_header_only_32x24.tif"] = planar_ojpeg(
        rgb[:24, :32], header_only=True)
    out["oj_planar_one_strip_32x24.tif"] = planar_ojpeg(rgb[:24, :32], True)
    # planes from tables: the second plane's SOS is not found, and the scan
    # for it leaves the first plane's open session without data
    out["oj_planar_tables_rps16_16x24.tif"] = ojpeg_file(
        rgb[:24, :16], (1, 1), 16, mode="tables", tags={284: 2})
    # strips missing, empty, cut, too long or past the end of the file
    base = {m: ojpeg_file(rgb[:48, :32], (2, 2), 16, mode=m)
            for m in ("jif", "tables")}
    base["grey"] = ojpeg_file(rgb[:24, :24], rows_per_strip=8, mode="jif",
                              grey=True)
    for m, data in base.items():
        size = "24x24" if m == "grey" else "32x48"
        for k in (0, 1, 2):
            out[f"oj_{m}_strip{k}_past_eof_{size}.tif"] = _strip_values(
                data, 273, k, 10 ** 6)
        out[f"oj_{m}_strip1_offset0_{size}.tif"] = _strip_values(
            data, 273, 1, 0)
        out[f"oj_{m}_strips12_past_eof_{size}.tif"] = _strip_values(
            _strip_values(data, 273, 1, 10 ** 6), 273, 2, 10 ** 6)
        out[f"oj_{m}_strip0_count10_{size}.tif"] = _strip_values(
            data, 279, 0, 10)
        out[f"oj_{m}_strip2_count0_{size}.tif"] = _strip_values(
            data, 279, 2, 0)
        out[f"oj_{m}_strip1_count_huge_{size}.tif"] = _strip_values(
            data, 279, 1, 10 ** 6)
    out["oj_jif_strip1_damaged_32x48.tif"] = ojpeg_file(
        rgb[:48, :32], (2, 2), 16, mode="jif",
        mutate=lambda k, s: bytes(b ^ 0x5A for b in s[:9]) + s[9:]
        if k == 1 else s)
    out["oj_jif_strip1_with_rst_32x48.tif"] = ojpeg_file(
        rgb[:48, :32], (2, 2), 16, mode="jif",
        mutate=lambda k, s: s + b"\xff\xd5" if k == 1 else s)


def _tables_offsets(pic: np.ndarray) -> tuple:
    """The offsets ojpeg_file(pic, mode="tables") gives its table tags."""
    data = ojpeg_file(pic, mode="tables")
    at = struct.unpack_from("<L", data, 4)[0]
    found = {}
    for i in range(struct.unpack_from("<H", data, at)[0]):
        tag, typ, count, val = struct.unpack_from("<HHLL", data,
                                                  at + 2 + 12 * i)
        if tag in (519, 520, 521):
            found[tag] = struct.unpack_from(f"<{count}L", data, val) \
                if count > 1 else (val,)
    return found[519], found[520], found[521]


def _sampled_jif(rgb: np.ndarray, sampling, grey: bool = False) -> bytes:
    """An old-style JPEG TIFF whose JPEGInterchangeFormat SOF has these
    sampling factors (grey: one component)."""
    h, w = rgb.shape[:2]
    hm = max(a for a, _ in sampling)
    vm = max(b for _, b in sampling)
    if grey:
        planes = [tj.downsample(rgb[..., 0], hm // sampling[0][0],
                                vm // sampling[0][1])]
    else:
        ycc = tj.ycbcr(rgb)
        planes = [tj.downsample(ycc[..., i],
                                max(1, hm // sampling[i][0]),
                                max(1, vm // sampling[i][1]))
                  for i in range(3)]
    n = len(planes)
    stream = tj.encode_planes(planes, sampling, Q75, [0, 1, 1][:n],
                              ids=list(range(1, n + 1)), height=h, width=w)
    head, segments = split_stream(stream)
    out = {256: w, 257: h, 258: (8,) * n if n > 1 else 8, 259: 6,
           262: 6 if n == 3 else 1, 277: n, 278: h,
           273: tc.chunks_in(1), 279: tc.chunks_in(1), 513: tj.typed(4, 8),
           514: tj.typed(4, len(head))}
    return tc.tiff_file(tj._entries(out), [head, segments[0]], ifd_last=True)


def _jif_with_markers(rgb: np.ndarray) -> bytes:
    """Three strips of 16 rows (one MCU row each, a restart interval
    each) whose JPEGInterchangeFormat header has an APP1, a COM and a DRI
    of two MCU rows: the stream's DRI wins over libtiff's one strip, so
    libjpeg looks for a restart marker every other strip."""
    h, w = rgb.shape[:2]
    planes = ycc_planes(rgb, (2, 2))
    mcus = -(-w // 16)
    stream = tj.encode_planes(planes, [(2, 2), (1, 1), (1, 1)], Q75,
                              [0, 1, 1], ids=[0, 1, 2], restart=mcus,
                              app=tj._segment(0xE1, b"Exif\0\0old") +
                              tj._segment(0xFE, b"scanner"),
                              height=h, width=w)
    head, segments = split_stream(stream)
    dri = head.find(b"\xff\xdd")
    head = head[:dri + 4] + struct.pack(">H", 2 * mcus) + head[dri + 6:]
    out = {256: w, 257: h, 258: (8, 8, 8), 259: 6, 262: 6, 277: 3,
           278: 16, 530: (2, 2), 273: tc.chunks_in(1, 2, 3),
           279: tc.chunks_in(1, 2, 3), 513: tj.typed(4, 8),
           514: tj.typed(4, len(head))}
    return tc.tiff_file(tj._entries(out), [head, *segments], ifd_last=True)


# -- the scenes --------------------------------------------------------------

def scene_cases(rgb: np.ndarray) -> dict:
    """The 640x480 scene for phase 9o."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    grey = rgb.astype(np.int64).sum(-1) // 3
    return {
        SCENES[0]: tiff12(grey, 16),
        SCENES[1]: ojpeg_file(rgb, (2, 2), 16, mode="jif"),
        SCENES[2]: ojpeg_file(rgb, (2, 2), 16, mode="tables"),
        ROTATED: ojpeg_file(rgb, (2, 2), 16, mode="jif", tags={274: 6}),
    }


def cases() -> dict:
    from tests import torch_jpeg_fixtures

    out = {}
    _j12_cases(out)
    _oj_cases(out)
    out.update(scene_cases(torch_jpeg_fixtures.scene(0)))
    return out


def load(folder: str = FOLDER, name: str = DIGESTS) -> dict:
    with open(os.path.join(folder, name)) as f:
        return json.load(f)


def write(folder: str = FOLDER) -> dict:
    """Write every case and digests.json into folder; returns the
    digests."""
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
    tc._dump(os.path.join(folder, DIGESTS), digests)
    return digests


def digest(img) -> str:
    return tj.digest(img)


if __name__ == "__main__":
    print(json.dumps(write(*sys.argv[1:]), indent=1, sort_keys=True))
