"""The YCbCr and JPEG TIFF corpus (tests/fixtures/torch_tiff_jpeg_corpus/):
files the JAX package hands to Pillow 12.1.0, whose TiffImagePlugin reads
them over libtiff 4.7.1 (its JPEG codec over libjpeg-turbo 3.1.3, its
TIFFRGBAImage for YCbCr), and which the port reads in data/tiff.py,
csrc/jpeg_decode.cc (mode 2) and csrc/tiff_decode.cc.

Small files made from numpy seeds, from four sources:

- Pillow's writer: RGB, L, YCbCr, CMYK and RGBA under ``jpeg`` at a few
  qualities (RGB as photometric 2, YCbCr as 6 with subsampling 1x1 and
  ReferenceBlackWhite, each with JPEGTables), YCbCr under LZW, deflate,
  PackBits and none, Orientation 1-8 through ``tiffinfo``;
- tests/torch_tiff_writer.c over Pillow's libtiff: JPEG strips and
  tiles, YCbCr subsampled by libtiff (JPEGCOLORMODE_RGB) at 1x1, 2x1, 1x2
  and 2x2, JPEGTables on and off, partial last strips, planar
  configuration 2, grey, min-is-white, RGB, RGBA and CMYK JPEG,
  big-endian, BigTIFF;
- written here with the numpy JPEG encoder (``jpeg_tiff``: baseline,
  Huffman, the standard tables, an integer DCT) and ``Tiff``'s
  ``tiff_file``: strips cut in their data or their header, JPEGTables cut
  or holding an image, tables carried from one strip to the next, JFIF
  and Adobe markers, restart markers, subsampling absent (read from the
  first strip's SOF), tags that disagree with the streams (subsampling,
  precision, sizes, component counts), duplicated tags;
- packed YCbCr sampling blocks (``ycbcr_file``) under LZW, deflate,
  PackBits and none at every subsampling, in strips, tiles (the 4x4
  putter's clipped tile) and planes, with ReferenceBlackWhite and
  YCbCrCoefficients, Orientation 1-8.

``digests.json`` holds, for each file, each JAX route's pixels' sha256
(tests/torch_tiff_corpus.py:reference; null where the route fails) and
the size Pillow reads. ``scene_digests.json`` holds the same for the
640x480 scenes (``scene_cases``), made at run time from
tests/torch_jpeg_fixtures.py:scene 0 with numpy alone, so chip_smoke.py
remakes them on the card. Remake the corpus (Pillow, the JAX package, g++
with the system's tiffio.h for the writer) with

  python -m tests.torch_tiff_jpeg_corpus [folder]

File names give the width before the height.
"""

import hashlib
import io
import json
import os
import struct
import sys
import zlib

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

FOLDER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                      "torch_tiff_jpeg_corpus")
DIGESTS = "digests.json"
SCENE_DIGESTS = "scene_digests.json"

# -- a baseline JPEG encoder in numpy and Python ------------------------------

LUMA = (16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14,
        13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22,
        37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92, 49, 64,
        78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99)
CHROMA = (17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
          24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99) + \
    (99,) * 32
# T.81 K.3: (bits 1-16, values) of DC luma, AC luma, DC chroma, AC chroma
STD_TABLES = (
    ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12))),
    ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a43444546474849"
        "4a535455565758595a636465666768696a737475767778797a83848586878889"
        "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
        "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
        "f9fa")),
    ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), bytes(range(12))),
    ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa")))
ZIGZAG = [r * 8 + c for s in range(15)
          for r, c in sorted(((r, s - r) for r in range(8) if 0 <= s - r < 8),
                             reverse=s % 2 == 0)]


def quant(quality: int, base=LUMA) -> np.ndarray:
    """IJG's table scaling (jcparam.c), natural order, held to 1-255."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((np.array(base) * scale + 50) // 100, 1, 255)


def fdct(blocks: np.ndarray) -> np.ndarray:
    """libjpeg's islow forward DCT (jfdctint.c) of (n, 8, 8) centred
    samples, in int64: 8 times the DCT, exact on any machine."""
    def one_pass(d, out_shift, first):
        d0, d1, d2, d3, d4, d5, d6, d7 = (d[..., i] for i in range(8))
        t0, t7, t1, t6 = d0 + d7, d0 - d7, d1 + d6, d1 - d6
        t2, t5, t3, t4 = d2 + d5, d2 - d5, d3 + d4, d3 - d4
        t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2

        def desc(x, n):
            return (x + (1 << (n - 1))) >> n
        out = [None] * 8
        if first:
            out[0], out[4] = (t10 + t11) << 2, (t10 - t11) << 2
        else:
            out[0], out[4] = desc(t10 + t11, 2), desc(t10 - t11, 2)
        z1 = (t12 + t13) * 4433
        out[2] = desc(z1 + t13 * 6270, out_shift)
        out[6] = desc(z1 - t12 * 15137, out_shift)
        z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
        z5 = (z3 + z4) * 9633
        t4, t5, t6, t7 = t4 * 2446, t5 * 16819, t6 * 25172, t7 * 12299
        z1, z2 = z1 * -7373, z2 * -20995
        z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
        out[7] = desc(t4 + z1 + z3, out_shift)
        out[5] = desc(t5 + z2 + z4, out_shift)
        out[3] = desc(t6 + z2 + z3, out_shift)
        out[1] = desc(t7 + z1 + z4, out_shift)
        return np.stack(out, -1)
    rows = one_pass(blocks.astype(np.int64), 11, True)
    cols = one_pass(rows.swapaxes(-1, -2), 15, False)
    return cols.swapaxes(-1, -2)


def quantize(coefs: np.ndarray, q: np.ndarray) -> np.ndarray:
    """jcdctmgr.c's rounding: |c| + q * 4, over q * 8, the sign kept."""
    div = q.reshape(8, 8) * 8
    mag = (np.abs(coefs) + (div >> 1)) // div
    return np.where(coefs < 0, -mag, mag)


def _codes(bits, vals) -> dict:
    codes, code, k = {}, 0, 0
    for length, n in enumerate(bits, 1):
        for _ in range(n):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code: int, size: int):
        self.acc = (self.acc << size) | code
        self.n += size
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 255
            self.out.append(b)
            if b == 255:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def table_segments(qs, huff=True) -> bytes:
    """DQT of each table (zigzag order) and DHT of the four standard
    tables."""
    out = b""
    for i, q in enumerate(qs):
        out += _segment(0xDB, bytes([i]) + bytes(int(q[z]) for z in ZIGZAG))
    if huff:
        for t, (bits, vals) in enumerate(STD_TABLES):
            out += _segment(0xC4, bytes([(t & 1) << 4 | t >> 1]) +
                            bytes(bits) + vals)
    return out


def encode_planes(planes, sampling, qs, tq, ids=None, restart: int = 0,
                  tables: bool = True, app: bytes = b"",
                  height: int = None, width: int = None,
                  precision: int = 8) -> bytes:
    """A baseline JPEG stream of component planes (each (h, w) uint8 at its
    own sampled size), sampling [(h, v)], quantization tables qs with the
    table tq[i] of each component, Huffman tables 0 (the first component)
    and 1 (the others); tables: DQT and DHT in the stream (else an
    abbreviated stream, the tables left to JPEGTables); app: segments
    after SOI; restart: a DRI interval in MCUs. height, width: the SOF's
    (default: the first plane's)."""
    n = len(planes)
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    height = height or planes[0].shape[0] * vmax // sampling[0][1]
    width = width or planes[0].shape[1] * hmax // sampling[0][0]
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    ids = ids or list(range(1, n + 1))
    coefs = []
    for p, (h, v), t in zip(planes, sampling, tq):
        ph, pw = mcuy * v * 8, mcux * h * 8
        pad = np.pad(p, ((0, max(0, ph - p.shape[0])),
                         (0, max(0, pw - p.shape[1]))), mode="edge")
        pad = pad[:ph, :pw].astype(np.int64) - 128
        b = pad.reshape(ph // 8, 8, pw // 8, 8).swapaxes(1, 2)
        c = quantize(fdct(b.reshape(-1, 8, 8)), qs[t])
        coefs.append(c.reshape(ph // 8, pw // 8, 64)[..., ZIGZAG])
    dc_codes = [_codes(*STD_TABLES[0]), _codes(*STD_TABLES[2])]
    ac_codes = [_codes(*STD_TABLES[1]), _codes(*STD_TABLES[3])]
    bits = _Bits()
    pred = [0] * n
    count = 0
    rst = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if restart and count and count % restart == 0:
                bits.flush()
                bits.out += bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) & 7
                pred = [0] * n
            count += 1
            for ci, (h, v) in enumerate(sampling):
                tab = 0 if ci == 0 else 1
                for by in range(v):
                    for bx in range(h):
                        c = coefs[ci][my * v + by, mx * h + bx]
                        diff = int(c[0]) - pred[ci]
                        pred[ci] = int(c[0])
                        size = abs(diff).bit_length()
                        bits.put(*dc_codes[tab][size])
                        if size:
                            bits.put(diff if diff > 0 else
                                     diff + (1 << size) - 1, size)
                        last = 0
                        for k in np.flatnonzero(c[1:]) + 1:
                            run = int(k) - last - 1
                            while run > 15:
                                bits.put(*ac_codes[tab][0xF0])
                                run -= 16
                            val = int(c[k])
                            size = abs(val).bit_length()
                            bits.put(*ac_codes[tab][run << 4 | size])
                            bits.put(val if val > 0 else
                                     val + (1 << size) - 1, size)
                            last = int(k)
                        if last < 63:
                            bits.put(*ac_codes[tab][0])
    bits.flush()
    sof = struct.pack(">BHHB", precision, height, width, n) + b"".join(
        struct.pack(">BBB", i, h << 4 | v, t)
        for i, (h, v), t in zip(ids, sampling, tq))
    sos = bytes([n]) + b"".join(
        struct.pack(">BB", i, 0 if ci == 0 else 0x11)
        for ci, i in enumerate(ids)) + bytes([0, 63, 0])
    out = b"\xff\xd8" + app
    if tables:
        out += table_segments(qs)
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    return out + _segment(0xC0, sof) + _segment(0xDA, sos) + \
        bytes(bits.out) + b"\xff\xd9"


def ycbcr(rgb: np.ndarray) -> np.ndarray:
    """RGB -> YCbCr in libjpeg's fixed point (jccolor.c), uint8."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, one = 1 << 15, 1 << 16

    def fix(x):
        return int(x * one + 0.5)
    y = (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b +
          (128 << 16) + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b +
          (128 << 16) + half - 1) >> 16
    return np.stack([y, cb, cr], -1).astype(np.uint8)


def downsample(plane: np.ndarray, h: int, v: int) -> np.ndarray:
    """The mean of each h x v box, rounded (edges replicated)."""
    H, W = plane.shape
    ph, pw = -(-H // v) * v, -(-W // h) * h
    pad = np.pad(plane, ((0, ph - H), (0, pw - W)), mode="edge")
    box = pad.reshape(ph // v, v, pw // h, h).astype(np.int64).sum((1, 3))
    return ((box + h * v // 2) // (h * v)).astype(np.uint8)


def jpeg_tiff(pixels: np.ndarray, photometric: int = 6, sampling=(2, 2),
              quality: int = 75, rows_per_strip: int = 16, tile: int = 0,
              with_tables: bool = True, restart: int = 0, app: bytes = b"",
              tags=None, drop=(), mutate=None, big: bool = False,
              endian: str = "<") -> bytes:
    """A JPEG-compressed TIFF of pixels ((h, w, 3) RGB for photometric 6
    or 2, (h, w) grey for 1, (h, w, 4) for 5) written with the numpy
    encoder: strips of rows_per_strip rows or square tiles, JPEGTables
    (the DQT and DHT) with abbreviated streams or, without, every stream
    whole. mutate(k, stream) -> stream changes chunk k's stream; tags
    override or add tags (a value, or typed(...)), drop removes them."""
    pixels = np.asarray(pixels, np.uint8)
    h, w = pixels.shape[:2]
    if photometric == 6:
        comps = ycbcr(pixels)
        sub = [tuple(sampling), (1, 1), (1, 1)]
        qs, tq = [quant(quality), quant(quality, CHROMA)], [0, 1, 1]
    else:
        comps = pixels.reshape(h, w, -1)
        sub = [(1, 1)] * comps.shape[-1]
        qs, tq = [quant(quality)], [0] * comps.shape[-1]
    n = comps.shape[-1]

    def stream(part: np.ndarray) -> bytes:
        planes = [part[..., 0]] + [
            downsample(part[..., i], sub[0][0], sub[0][1])
            if photometric == 6 else part[..., i] for i in range(1, n)]
        return encode_planes(planes, sub, qs, tq, ids=list(range(n)),
                             restart=restart, tables=not with_tables,
                             app=app, height=part.shape[0],
                             width=part.shape[1])

    chunks = []
    out = {256: w, 257: h, 258: (8,) * n if n > 1 else 8, 259: 7,
           262: photometric, 277: n}
    if tile:
        for y in range(0, h, tile):
            for x in range(0, w, tile):
                part = np.zeros((tile, tile, n), np.uint8)
                src = comps[y:y + tile, x:x + tile]
                part[:src.shape[0], :src.shape[1]] = src
                chunks.append(stream(part))
        out.update({322: tile, 323: tile, 324: tc.CHUNKS, 325: tc.CHUNKS})
    else:
        for y in range(0, h, rows_per_strip):
            chunks.append(stream(comps[y:y + rows_per_strip]))
        out.update({273: tc.CHUNKS, 278: rows_per_strip, 279: tc.CHUNKS})
    if photometric == 6:
        out[530] = tuple(sampling)
    if with_tables:
        out[347] = b"\xff\xd8" + table_segments(qs) + b"\xff\xd9"
    if mutate is not None:
        chunks = [mutate(k, c) for k, c in enumerate(chunks)]
    out.update(tags or {})
    for tag in drop:
        out.pop(tag, None)
    return tc.tiff_file(_entries(out), chunks, big=big, endian=endian)


def typed(typ: int, value, count=None):
    """A tag value of a given type (and count) for jpeg_tiff's and
    ycbcr_file's tags."""
    return _Typed(typ, value, count)


class _Typed(tuple):
    def __new__(cls, typ, value, count):
        return super().__new__(cls, (typ, value, count))


def _entries(tags: dict) -> list:
    return [(t, v[0], v[1], v[2]) if isinstance(v, _Typed) else (t, v)
            for t, v in tags.items()]


def blocks(ycc: np.ndarray, h: int, v: int) -> np.ndarray:
    """Packed sampling blocks of (H, W, 3) YCbCr: each block's h x v Y
    samples (rows in turn), then the Cb and Cr of its top-left pixel;
    rows of blocks, the image padded with zeros."""
    H, W = ycc.shape[:2]
    bh, bw = -(-H // v), -(-W // h)
    pad = np.zeros((bh * v, bw * h, 3), np.uint8)
    pad[:H, :W] = ycc
    ys = pad[..., 0].reshape(bh, v, bw, h).transpose(0, 2, 1, 3) \
        .reshape(bh, bw, v * h)
    return np.concatenate([ys, pad[::v, ::h, 1:]], -1).reshape(bh, -1)


def ycbcr_file(ycc: np.ndarray, sub=(2, 2), codec: str = "lzw",
               rows_per_strip: int = 0, tile: int = 0, planar: bool = False,
               tags=None, drop=(), big: bool = False,
               endian: str = "<") -> bytes:
    """A YCbCr TIFF of (H, W, 3) samples: packed sampling blocks (or
    three planes) under codec "lzw", "deflate", "packbits" or "raw" (or a
    (Compression, encode) pair), in strips or square tiles; tags override
    or add tags, drop removes them."""
    H, W = ycc.shape[:2]
    h, v = sub
    if isinstance(codec, tuple):
        comp, enc = codec
    else:
        enc = {"lzw": tc.lzw, "raw": lambda b: b, "packbits": tc.packbits,
               "deflate": zlib.compress}[codec]
        comp = {"lzw": 5, "raw": 1, "packbits": 32773, "deflate": 8}[codec]
    out = {256: W, 257: H, 258: (8, 8, 8), 259: comp, 262: 6, 277: 3,
           530: tuple(sub)}
    chunks = []
    rps = rows_per_strip or H
    if planar:
        out[284] = 2
        for p in range(3):
            for y in range(0, H, rps):
                chunks.append(enc(np.ascontiguousarray(
                    ycc[y:y + rps, :, p]).tobytes()))
        out.update({273: tc.CHUNKS, 278: rps, 279: tc.CHUNKS})
    elif tile:
        for y in range(0, H, tile):
            for x in range(0, W, tile):
                t = np.zeros((tile, tile, 3), np.uint8)
                part = ycc[y:y + tile, x:x + tile]
                t[:part.shape[0], :part.shape[1]] = part
                chunks.append(enc(blocks(t, h, v).tobytes()))
        out.update({322: tile, 323: tile, 324: tc.CHUNKS, 325: tc.CHUNKS})
    else:
        for y in range(0, H, rps):
            chunks.append(enc(blocks(ycc[y:y + rps], h, v).tobytes()))
        out.update({273: tc.CHUNKS, 278: rps, 279: tc.CHUNKS})
    out.update(tags or {})
    for t in drop:
        out.pop(t, None)
    return tc.tiff_file(_entries(out), chunks, big=big, endian=endian)


# -- the cases ---------------------------------------------------------------

def picture(seed: int, h: int, w: int) -> np.ndarray:
    """Smooth colours with some noise: (h, w, 3) uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 127 // max(h + w - 2, 1)], -1)
    return np.clip(base + rng.integers(-24, 25, (h, w, 3)), 0,
                   255).astype(np.uint8)


def pillow_tiff(rgb: np.ndarray, mode: str, **save) -> bytes:
    from PIL import Image

    out = io.BytesIO()
    Image.fromarray(rgb).convert(mode).save(out, "TIFF", **save)
    return out.getvalue()


def _strip(k: int, fn):
    """A mutate= of chunk k alone."""
    return lambda i, s: fn(s) if i == k else s


def _sof_patch(stream: bytes, at: int, value: int) -> bytes:
    """stream with byte at (counted from the SOF0 marker) set to value."""
    i = stream.index(b"\xff\xc0")
    return stream[:i + at] + bytes([value]) + stream[i + at + 1:]


def _pillow_cases(out: dict):
    rgb = picture(1, 13, 19)
    for mode in ("RGB", "L", "YCbCr", "CMYK", "RGBA"):
        for q in (30, 75, 95):
            out[f"pw_jpeg_{mode.lower()}_q{q}_19x13.tif"] = pillow_tiff(
                rgb, mode, compression="jpeg", quality=q)
    for o in range(1, 9):
        out[f"pw_jpeg_ycbcr_orient{o}_19x13.tif"] = pillow_tiff(
            rgb, "YCbCr", compression="jpeg", tiffinfo={274: o})
        out[f"pw_jpeg_rgb_orient{o}_19x13.tif"] = pillow_tiff(
            rgb, "RGB", compression="jpeg", tiffinfo={274: o})
    big = picture(2, 37, 45)
    out["pw_jpeg_ycbcr_45x37.tif"] = pillow_tiff(big, "YCbCr",
                                                 compression="jpeg")
    for comp in ("tiff_lzw", "tiff_deflate", "tiff_adobe_deflate",
                 "packbits", "raw"):
        name = comp.replace("tiff_", "")
        out[f"pw_ycbcr_{name}_19x13.tif"] = pillow_tiff(
            rgb, "YCbCr", compression=comp)
    for o in (2, 3, 6, 8):
        out[f"pw_ycbcr_lzw_orient{o}_19x13.tif"] = pillow_tiff(
            rgb, "YCbCr", compression="tiff_lzw", tiffinfo={274: o})


def _libtiff_cases(out: dict):
    rgb = picture(3, 29, 37)
    lt = tc.libtiff
    for sub in ((1, 1), (2, 1), (1, 2), (2, 2)):
        name = f"{sub[0]}{sub[1]}"
        base = dict(photometric=6, compression=7, jpegcolormode=1,
                    subsampling=sub)
        out[f"lw_ycbcr{name}_strips16_37x29.tif"] = lt(
            rgb, rows_per_strip=16, **base)
        out[f"lw_ycbcr{name}_strips32_37x29.tif"] = lt(
            rgb, rows_per_strip=32, **base)
        out[f"lw_ycbcr{name}_tiles16_37x29.tif"] = lt(
            rgb, tile_width=16, tile_height=16, **base)
        for mode in (0, 1, 2):
            out[f"lw_ycbcr{name}_tablesmode{mode}_37x29.tif"] = lt(
                rgb, rows_per_strip=16, jpegtablesmode=mode, **base)
    base = dict(photometric=6, compression=7, jpegcolormode=1,
                subsampling=(2, 2), rows_per_strip=16)
    for q in (10, 50, 90):
        out[f"lw_ycbcr22_q{q}_37x29.tif"] = lt(rgb, quality=q, **base)
    out["lw_ycbcr22_bigendian_37x29.tif"] = lt(rgb, bigendian=1, **base)
    out["lw_ycbcr22_bigtiff_37x29.tif"] = lt(rgb, bigtiff=1, **base)
    out["lw_ycbcr22_tiles32_bigtiff_be_37x29.tif"] = lt(
        rgb, photometric=6, compression=7, jpegcolormode=1,
        subsampling=(2, 2), tile_width=32, tile_height=32, bigtiff=1,
        bigendian=1)
    for o in range(1, 9):
        out[f"lw_ycbcr22_orient{o}_37x29.tif"] = lt(rgb, orientation=o,
                                                    **base)
    out["lw_ycbcr22_refbw_coeff_37x29.tif"] = lt(
        rgb, refbw=(16, 235, 128, 240, 128, 240),
        coefficients=(0.2125, 0.7154, 0.0721), positioning=2, **base)
    plain = dict(compression=7, rows_per_strip=8)
    grey = rgb[..., :1]
    out["lw_grey_jpeg_37x29.tif"] = lt(grey, photometric=1, **plain)
    out["lw_miniswhite_jpeg_37x29.tif"] = lt(grey, photometric=0, **plain)
    out["lw_grey_jpeg_tiles16_37x29.tif"] = lt(
        grey, photometric=1, compression=7, tile_width=16, tile_height=16)
    out["lw_rgb_jpeg_37x29.tif"] = lt(rgb, photometric=2, **plain)
    out["lw_rgb_jpeg_tiles16_be_37x29.tif"] = lt(
        rgb, photometric=2, compression=7, tile_width=16, tile_height=16,
        bigendian=1)
    out["lw_rgb_jpeg_planar_37x29.tif"] = lt(rgb, photometric=2, planar=2,
                                             **plain)
    out["lw_rgb_jpeg_planar_tiles16_37x29.tif"] = lt(
        rgb, photometric=2, planar=2, compression=7, tile_width=16,
        tile_height=16)
    rgba = np.concatenate([rgb, rgb[..., :1]], -1)
    out["lw_rgba_jpeg_37x29.tif"] = lt(rgba, photometric=2, extra=(2,),
                                       **plain)
    out["lw_cmyk_jpeg_37x29.tif"] = lt(rgba, photometric=5, **plain)
    out["lw_cmyk_jpeg_planar_37x29.tif"] = lt(rgba, photometric=5, planar=2,
                                              **plain)
    out["lw_ycbcr11_jpeg_planar_37x29.tif"] = lt(
        rgb, photometric=6, planar=2, subsampling=(1, 1), **plain)
    out["lw_ycbcr11_jpeg_planar_tiles16_37x29.tif"] = lt(
        rgb, photometric=6, planar=2, subsampling=(1, 1), compression=7,
        tile_width=16, tile_height=16)
    out["lw_ycbcr11_jpeg_planar_rps5_37x29.tif"] = lt(
        rgb, photometric=6, planar=2, subsampling=(1, 1), compression=7,
        rows_per_strip=8, orientation=3)


def _jpeg_cases(out: dict):
    """The numpy encoder's files: layouts, markers, cuts and tags that
    disagree with the streams."""
    rgb = picture(4, 13, 19)
    jt = jpeg_tiff
    for sub in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2)):
        name = f"{sub[0]}{sub[1]}"
        out[f"hm_ycbcr{name}_19x13.tif"] = jt(rgb, 6, sub, rows_per_strip=8
                                              if sub[1] < 4 else 16)
    out["hm_ycbcr22_tiles16_19x13.tif"] = jt(rgb, 6, tile=16)
    out["hm_ycbcr22_notables_19x13.tif"] = jt(rgb, 6, with_tables=False)
    out["hm_ycbcr22_restart1_19x13.tif"] = jt(rgb, 6, restart=1)
    out["hm_grey_19x13.tif"] = jt(rgb[..., 0], 1)
    out["hm_rgb_19x13.tif"] = jt(rgb, 2)
    out["hm_cmyk_19x13.tif"] = jt(np.concatenate([rgb, rgb[..., :1]], -1),
                                  5)
    # markers the colour space must ignore
    jfif = _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    adobe0 = _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")
    adobe1 = _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x01")
    out["hm_ycbcr22_jfif_19x13.tif"] = jt(rgb, 6, app=jfif)
    out["hm_ycbcr22_adobe_rgb_19x13.tif"] = jt(rgb, 6, app=adobe0)
    out["hm_rgb_adobe_ycc_19x13.tif"] = jt(rgb, 2, app=adobe1)
    out["hm_rgb_jfif_19x13.tif"] = jt(rgb, 2, app=jfif + _segment(
        0xFE, b"a comment"))
    # cuts: a stream runs into the fake EOI libtiff's source supplies (two
    # strips where the second is changed)
    two = dict(rows_per_strip=8)
    for n in (40, 120, 200):
        out[f"hm_ycbcr22_strip0_cut{n}_19x13.tif"] = jt(
            rgb, 6, mutate=_strip(0, lambda s, n=n: s[:n]))
    out["hm_ycbcr22_strip1_no_eoi_19x13.tif"] = jt(
        rgb, 6, mutate=_strip(1, lambda s: s[:-2]), **two)
    out["hm_ycbcr22_strip1_empty_scan_19x13.tif"] = jt(
        rgb, 6, mutate=_strip(1, lambda s: s[:s.index(b"\xff\xda") + 12]),
        **two)
    out["hm_ycbcr22_strip0_no_sos_19x13.tif"] = jt(
        rgb, 6, mutate=_strip(0, lambda s: s[:s.index(b"\xff\xda")]))
    out["hm_ycbcr22_strip0_no_soi_19x13.tif"] = jt(
        rgb, 6, mutate=_strip(0, lambda s: s[2:]))
    out["hm_ycbcr22_junk_after_eoi_19x13.tif"] = jt(
        rgb, 6, mutate=_strip(0, lambda s: s + b"\xff\xc4\x00\x03\x00"))
    out["hm_ycbcr22_second_sos_19x13.tif"] = jt(
        rgb, 6, mutate=_strip(0, lambda s: s[:-2] + s[s.index(b"\xff\xda"):]))
    out["hm_ycbcr22_bad_dht_before_eoi_19x13.tif"] = jt(
        rgb, 6, mutate=_strip(0, lambda s: s[:-2] + b"\xff\xc4\x00\x03\x00"
                              b"\xff\xd9"))
    tables = b"\xff\xd8" + table_segments([quant(75), quant(75, CHROMA)]) + \
        b"\xff\xd9"
    out["hm_tables_no_eoi_19x13.tif"] = jt(rgb, 6, tags={347: tables[:-2]})
    out["hm_tables_cut_in_dht_19x13.tif"] = jt(rgb, 6,
                                              tags={347: tables[:200]})
    out["hm_tables_dqt_only_19x13.tif"] = jt(
        rgb, 6, tags={347: b"\xff\xd8" + table_segments(
            [quant(75), quant(75, CHROMA)], huff=False) + b"\xff\xd9"})
    out["hm_tables_no_soi_19x13.tif"] = jt(rgb, 6, tags={347: tables[2:]})
    out["hm_tables_holding_image_19x13.tif"] = jt(
        rgb, 6, tags={347: encode_planes(
            [rgb[..., 0]], [(1, 1)], [quant(75), quant(75, CHROMA)], [0])})
    out["hm_tables_absent_19x13.tif"] = jt(rgb, 6, drop=(347,))
    out["hm_tables_in_strip0_only_19x13.tif"] = jt(
        rgb, 6, drop=(347,), mutate=_strip(
            0, lambda s: s[:2] + tables[2:-2] + s[2:]), **two)
    out["hm_tables_redefined_strip0_19x13.tif"] = jt(
        rgb, 6, mutate=_strip(0, lambda s: s[:2] + table_segments(
            [quant(20), quant(20, CHROMA)], huff=False) + s[2:]), **two)
    out["hm_tables_type_byte_19x13.tif"] = jt(rgb, 6, tags={347: typed(
        1, tables)})
    out["hm_tables_type_short_19x13.tif"] = jt(rgb, 6, tags={347: typed(
        3, tuple(tables))})
    out["hm_tables_past_end_19x13.tif"] = tc.patched(
        jt(rgb, 6, tags={347: tables}), 347, 1 << 20)
    # the subsampling: absent (read from the first SOF), of a wrong count,
    # other than the stream's
    for sub in ((2, 2), (2, 1), (1, 1), (1, 2)):
        name = f"{sub[0]}{sub[1]}"
        out[f"hm_ycbcr{name}_no_subsampling_tag_19x13.tif"] = jt(
            rgb, 6, sub, drop=(530,))
    out["hm_ycbcr21_subsampling_count3_19x13.tif"] = jt(
        rgb, 6, (2, 1), tags={530: (1, 1, 1)})
    out["hm_ycbcr21_subsampling_long_19x13.tif"] = jt(
        rgb, 6, (2, 1), tags={530: typed(4, (2, 1))})
    out["hm_ycbcr22_tag11_19x13.tif"] = jt(rgb, 6, (2, 2), tags={530: (1, 1)})
    out["hm_ycbcr11_tag22_19x13.tif"] = jt(rgb, 6, (1, 1), tags={530: (2, 2)})
    out["hm_ycbcr22_tag44_19x13.tif"] = jt(rgb, 6, (2, 2), tags={530: (4, 4)})
    out["hm_ycbcr22_tag33_19x13.tif"] = jt(rgb, 6, (2, 2), tags={530: (3, 3)})
    out["hm_ycbcr21_no_tag_first_strip_cut_19x13.tif"] = jt(
        rgb, 6, (2, 1), drop=(530,), mutate=_strip(0, lambda s: s[:30]))
    # tags that disagree with the streams
    out["hm_ycbcr22_precision12_19x13.tif"] = jt(
        rgb, 6, mutate=_strip(0, lambda s: _sof_patch(s, 4, 12)))
    out["hm_ycbcr22_stream_wider_19x13.tif"] = jt(
        rgb, 6, mutate=_strip(1, lambda s: _sof_patch(s, 8, 40)), **two)
    out["hm_ycbcr22_last_strip_taller_19x13.tif"] = jt(
        rgb, 6, mutate=_strip(1, lambda s: _sof_patch(s, 6, 8)), **two)
    out["hm_ycbcr22_strip0_taller_19x13.tif"] = jt(
        rgb, 6, mutate=_strip(0, lambda s: _sof_patch(s, 6, 16)), **two)
    out["hm_rgb_spp4_19x13.tif"] = jt(rgb, 2, tags={277: 4, 258: (8,) * 4})
    out["hm_grey_bps12_19x13.tif"] = jt(rgb[..., 0], 1, tags={258: 12})
    out["hm_ycbcr22_photometric_rgb_19x13.tif"] = jt(rgb, 6, tags={262: 2})
    out["hm_rgb_photometric_ycbcr_19x13.tif"] = jt(rgb, 2, tags={262: 6})
    # duplicated tags: Pillow takes the last, libtiff the first
    base = jt(rgb, 6)
    out["hm_dup_photometric_2_then_6_19x13.tif"] = _with_dup(base, 262, 2)
    out["hm_dup_subsampling_11_then_22_19x13.tif"] = _with_dup(
        base, 530, (1, 1))
    out["hm_dup_compression_lzw_then_jpeg_19x13.tif"] = _with_dup(
        base, 259, 5)
    # whole interchange streams from another encoder, wrapped
    from PIL import Image

    for name, kw in (("baseline", {}), ("progressive",
                                        {"progressive": True})):
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, "JPEG", quality=80, subsampling=2,
                                  **kw)
        out[f"hm_pil_{name}_wrapped_19x13.tif"] = tc.tiff_file(
            {256: 19, 257: 13, 258: (8, 8, 8), 259: 7, 262: 6, 277: 3,
             278: 13, 273: tc.CHUNKS, 279: tc.CHUNKS, 530: (2, 2)},
            [buf.getvalue()])
    # counts past the end of the file: the read fails
    data = jt(rgb, 6)
    out["hm_ycbcr22_count_past_end_19x13.tif"] = data[:-20]


def _with_dup(data: bytes, tag: int, value) -> bytes:
    """data (a classic little-endian file of tiff_file) rewritten with a
    first entry for tag holding value before the existing one."""
    at = struct.unpack_from("<L", data, 4)[0]
    n = struct.unpack_from("<H", data, at)[0]
    entries = [data[at + 2 + 12 * i:at + 14 + 12 * i] for i in range(n)]
    values = value if isinstance(value, tuple) else (value,)
    field = struct.pack(f"<{len(values)}H", *values).ljust(4, b"\0")
    new = struct.pack("<HHL", tag, 3, len(values)) + field
    pos = next(i for i, e in enumerate(entries)
               if struct.unpack_from("<H", e)[0] == tag)
    entries.insert(pos, new)
    # the IFD grows by 12 bytes: move it to the end of the file
    ifd = struct.pack("<H", n + 1) + b"".join(entries) + bytes(4)
    end = len(data) + (len(data) & 1)
    out = bytearray(data + bytes(end - len(data)) + ifd)
    struct.pack_into("<L", out, 4, end)
    return bytes(out)


def _ycbcr_cases(out: dict):
    """Packed sampling blocks (and planes) through TIFFRGBAImage."""
    rgb = picture(5, 13, 19)
    ycc = ycbcr(rgb)
    yf = ycbcr_file
    subs = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))
    for sub in subs + ((2, 4), (3, 1), (1, 4)):
        name = f"{sub[0]}{sub[1]}"
        out[f"yc_lzw_{name}_19x13.tif"] = yf(ycc, sub)
        out[f"yc_lzw_{name}_rps5_19x13.tif"] = yf(ycc, sub,
                                                  rows_per_strip=5)
        out[f"yc_lzw_{name}_tiles16_19x13.tif"] = yf(ycc, sub, tile=16)
    for codec in ("deflate", "packbits", "raw"):
        for sub in ((1, 1), (2, 2), (4, 4), (4, 2)):
            name = f"{sub[0]}{sub[1]}"
            out[f"yc_{codec}_{name}_rps4_19x13.tif"] = yf(
                ycc, sub, codec, rows_per_strip=4)
        out[f"yc_{codec}_22_tiles16_19x13.tif"] = yf(ycc, (2, 2), codec,
                                                     tile=16)
    out["yc_lzw_planar_19x13.tif"] = yf(ycc, (1, 1), planar=True)
    out["yc_lzw_planar_rps3_19x13.tif"] = yf(ycc, (1, 1), planar=True,
                                             rows_per_strip=3)
    out["yc_lzw_planar_sub22_19x13.tif"] = yf(ycc, (2, 2), planar=True)
    out["yc_raw_planar_19x13.tif"] = yf(ycc, (1, 1), "raw", planar=True)
    out["yc_lzw_22_bigendian_19x13.tif"] = yf(ycc, (2, 2), endian=">")
    out["yc_lzw_22_bigtiff_19x13.tif"] = yf(ycc, (2, 2), big=True)
    out["yc_lzw_no_subsampling_tag_19x13.tif"] = yf(ycc, (2, 2),
                                                    drop=(530,))
    for o in range(1, 9):
        out[f"yc_lzw_22_orient{o}_19x13.tif"] = yf(ycc, (2, 2),
                                                   rows_per_strip=5,
                                                   tags={274: o})
    out["yc_lzw_22_tiles16_orient6_19x13.tif"] = yf(ycc, (2, 2), tile=16,
                                                    tags={274: 6})
    for name, rb in (("studio", (16, 235, 128, 240, 128, 240)),
                     ("odd", (10, 200, 30, 220, 60, 250)),
                     ("flat", (0, 0, 0, 0, 0, 0))):
        out[f"yc_lzw_21_refbw_{name}_19x13.tif"] = yf(
            ycc, (2, 1), tags={532: typed(5, sum(((v, 1) for v in rb),
                                                 ()))})
    for name, co in (("bt709", (2125, 7154, 721)),
                     ("green_tiny", (5000, 1, 5000)),
                     ("green_zero", (5000, 0, 5000))):
        out[f"yc_lzw_21_coeff_{name}_19x13.tif"] = yf(
            ycc, (2, 1), tags={529: typed(5, sum(((v, 10000) for v in co),
                                                 ()))})
    # a rational float32 division rounds other than a double one (every
    # Cb value present)
    ramp = ycbcr(picture(7, 16, 32))
    ramp[..., 1] = np.repeat(np.arange(256, dtype=np.uint8).reshape(16, 16),
                             2, axis=1)
    out["yc_lzw_21_refbw_rational_32x16.tif"] = yf(
        ramp, (2, 1), tags={532: typed(5, (0, 1, 255, 1, 128, 1, 161783982,
                                          618880, 128, 1, 255, 1))})
    out["yc_lzw_21_refbw_count5_19x13.tif"] = yf(
        ycc, (2, 1), tags={532: typed(5, (16, 1) * 5)})
    out["yc_lzw_21_refbw_double_19x13.tif"] = yf(
        ycc, (2, 1), tags={532: typed(12, (16.5, 235.0, 128.25, 240.0,
                                           128.0, 240.0))})
    # chunks that fail: TIFFRGBAImage reads on with what the codec left
    strips = ycbcr_file(ycc, (2, 2), rows_per_strip=4)
    out["yc_lzw_22_rps4_strip1_cut_19x13.tif"] = _cut_chunk(strips, 1, 10)
    out["yc_lzw_22_rps4_strip0_cut_19x13.tif"] = _cut_chunk(strips, 0, 10)
    tiles = ycbcr_file(ycbcr(picture(6, 20, 40)), (2, 2), tile=16)
    out["yc_lzw_22_tiles16_tile1_cut_40x20.tif"] = _cut_chunk(tiles, 1, 9)
    out["yc_lzw_22_tiles16_tile1_past_end_40x20.tif"] = _cut_chunk(
        tiles, 1, None)
    out["yc_lzw_22_tiles16_tile0_past_end_40x20.tif"] = _cut_chunk(
        tiles, 0, None)
    # a tile over 1e8 bytes from 1000 times fewer: refused before its
    # buffer is allocated
    out["yc_lzw_22_tile_length_huge_19x13.tif"] = yf(
        ycc, (2, 2), tile=16, tags={323: 10223632})
    grey = ycc[..., :1]
    out["yc_grey_lzw_19x13.tif"] = tc.tiff_file(
        {256: 19, 257: 13, 258: 8, 259: 5, 262: 6, 277: 1, 273: tc.CHUNKS,
         278: 13, 279: tc.CHUNKS}, [tc.lzw(grey.tobytes())])
    out["yc_grey_raw_19x13.tif"] = tc.tiff_file(
        {256: 19, 257: 13, 258: 8, 259: 1, 262: 6, 277: 1, 273: tc.CHUNKS,
         278: 13, 279: tc.CHUNKS}, [grey.tobytes()])
    # uncompressed YCbCr with four bytes a pixel: Pillow's RGBX reads them
    out["yc_raw_4bytes_19x13.tif"] = tc.tiff_file(
        {256: 19, 257: 13, 258: (8, 8, 8), 259: 1, 262: 6, 277: 3,
         273: tc.CHUNKS, 278: 13, 279: tc.CHUNKS},
        [np.concatenate([ycc, ycc[..., :1]], -1).tobytes()])


def _cut_chunk(data: bytes, k: int, keep) -> bytes:
    """A little-endian tiff_file of strips or tiles with chunk k's byte
    count cut to keep bytes (None: pointed past the end of the file)."""
    at = struct.unpack_from("<L", data, 4)[0]
    n = struct.unpack_from("<H", data, at)[0]
    data = bytearray(data)
    for i in range(n):
        e = at + 2 + 12 * i
        tag, typ, count = struct.unpack_from("<HHL", data, e)
        if tag in (273, 324) and keep is None:
            where = e + 8 if count == 1 else struct.unpack_from(
                "<L", data, e + 8)[0] + 4 * k
            struct.pack_into("<L", data, where, len(data) + 100)
        if tag in (279, 325) and keep is not None:
            where = e + 8 if count == 1 else struct.unpack_from(
                "<L", data, e + 8)[0] + 4 * k
            struct.pack_into("<L", data, where, keep)
    return bytes(data)


def cases() -> dict:
    out = {}
    _pillow_cases(out)
    _libtiff_cases(out)
    _jpeg_cases(out)
    _ycbcr_cases(out)
    return out


# -- generated at run time: the 640x480 scenes -------------------------------

def raw_ycbcr(rgb: np.ndarray) -> bytes:
    """An uncompressed YCbCr TIFF whose strip holds four bytes a pixel
    (the scene's RGB and a pad): Pillow's raw route unpacks RGBX, so it
    reads the RGB back."""
    h, w = rgb.shape[:2]
    return tc.tiff_file(
        {256: w, 257: h, 258: (8, 8, 8), 259: 1, 262: 6, 277: 3,
         273: tc.CHUNKS, 278: h, 279: tc.CHUNKS},
        [np.concatenate([rgb, rgb[..., :1]], -1).tobytes()])


def scene_cases(rgb: np.ndarray) -> dict:
    """A 640x480 scene (tests/torch_jpeg_fixtures.py:scene 0) as YCbCr
    2x2 JPEG with JPEGTables, RGB JPEG (photometric 2, Pillow's layout),
    grey JPEG, YCbCr 2x2 LZW (TIFFRGBAImage) and uncompressed YCbCr
    (Pillow's raw route): numpy and zlib only."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    grey = (rgb.astype(np.int64).sum(-1) // 3).astype(np.uint8)
    return {
        "scene_ycbcr22_jpeg_640x480.tif": jpeg_tiff(rgb, 6, (2, 2)),
        "scene_rgb_jpeg_640x480.tif": jpeg_tiff(rgb, 2, rows_per_strip=480),
        "scene_grey_jpeg_640x480.tif": jpeg_tiff(grey, 1),
        "scene_ycbcr22_lzw_640x480.tif": ycbcr_file(ycbcr(rgb), (2, 2),
                                                    rows_per_strip=16),
        "scene_ycbcr_raw_640x480.tif": raw_ycbcr(rgb),
    }


def load(folder: str = FOLDER, name: str = DIGESTS) -> dict:
    with open(os.path.join(folder, name)) as f:
        return json.load(f)


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
        digests[name] = tc.reference(path)
    tc._dump(os.path.join(folder, DIGESTS), digests)
    scenes = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, data in sorted(scene_cases(
                torch_jpeg_fixtures.scene(0)).items()):
            path = os.path.join(tmp, name)
            with open(path, "wb") as f:
                f.write(data)
            scenes[name] = tc.reference(path)
    tc._dump(os.path.join(folder, SCENE_DIGESTS), scenes)
    return digests


def digest(img) -> str:
    return None if img is None else hashlib.sha256(
        np.ascontiguousarray(img).tobytes()).hexdigest()


if __name__ == "__main__":
    print(json.dumps(write(*sys.argv[1:]), indent=1, sort_keys=True))
