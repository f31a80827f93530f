"""The WebP corpus (tests/fixtures/torch_webp_corpus/): files the JAX
package hands to Pillow 12.1.0, which decodes them over its bundled libwebp
1.6.0, and which the port decodes in its own C (csrc/webp_decode.cc).

Small files made from numpy seeds, one for each case the port must take as
Pillow takes it:

- lossy (VP8), written through Pillow's own libwebp by the writer
  tests/torch_webp_writer.c with full WebPConfig control: the simple loop
  filter, sharpness 0-7, filter level 0 and the highest, 1, 2, 4 and 8
  token partitions, 1-4 segments, every method 0-6, quality 0 and 100,
  spatial noise shaping off and full, sizes 1x1 to 67x67 with odd widths
  and heights; files a seeded search found for rules no plainer file
  reaches (a 4x4 block reading the last column's top-right, the y2 AC
  clamp, filter levels at the hev thresholds), and two whose overwritten
  token bytes give coefficients past the 16 bits of libwebp's SSE2
  inverse transform;
- alpha (VP8X with ALPH): the writer's alpha compression on and off under
  each of its filterings, a quantized alpha plane, exact RGB under alpha;
  and ALPH chunks written here, raw and VP8L-coded under each of the four
  filters (none, horizontal, vertical, gradient);
- lossless (VP8L) through Pillow's writer: palettes of 2, 3, 4, 5, 16, 17
  and 256 colours at widths their pixel bundling does not divide, methods
  0-6, alpha with and without exact; and VP8L streams written here for
  what libwebp's encoder never writes: a palette index past the palette,
  a plane distance below 1, an alpha symbol read past the end of its
  data;
- the container: an animation whose first frame sits at an offset (VP8,
  VP8L, VP8 with ALPH), Pillow's own animated writer, an ANMF whose header
  size disagrees with its bitstream, ICC and EXIF chunks, an unknown chunk,
  bytes after the RIFF, an ALPH chunk without the VP8X alpha flag;
- files Pillow refuses: cut files, bad RIFF sizes, a VP8X chunk of 12
  bytes, a token partition cut short, bad ALPH streams, a frame outside
  its canvas, a canvas past the decompression-bomb limit, a VP8L stream
  one byte short;
- a 640x480 scene (tests/torch_jpeg_fixtures.py:scene 0) lossy, lossless
  and lossy with alpha.

``digests.json`` holds, for each file, the sha256 of each JAX route's
pixels on this machine, null where it fails: ``loader`` is the JAX
server's ``_decode_image`` (the server, the loader, detect ``--all``; for
WebP, Pillow), ``img`` is ``np.asarray(Image.open(f).convert("RGB"))``
(detect ``--img``), and ``hw`` the (h, w) Pillow's open reads.
``chip_smoke.py`` holds the port to them on a machine without Pillow.
Remake the corpus (Pillow, the JAX package and g++ with the system's
webp/encode.h needed) with

  python -m tests.torch_webp_corpus [folder]

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

import numpy as np

from tests import torch_jpeg_corpus as jcorpus
from tests import torch_jpeg_fixtures
from tests import torch_pillow_corpus as pcorpus

FOLDER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                      "torch_webp_corpus")
DIGESTS = "digests.json"
WRITER_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "torch_webp_writer.c")

digest = pcorpus.digest
pillow_decode = pcorpus.pillow_decode
pillow_size = pcorpus.pillow_size
reference = pcorpus.reference

# -- the writer on Pillow's libwebp -------------------------------------------

SETTINGS = ("lossless", "quality", "method", "filter_type", "filter_strength",
            "filter_sharpness", "partitions", "segments", "sns_strength",
            "alpha_compression", "alpha_filtering", "alpha_quality", "exact")
DEFAULTS = dict(lossless=0, quality=75, method=4, filter_type=1,
                filter_strength=60, filter_sharpness=0, partitions=0,
                segments=4, sns_strength=50, alpha_compression=1,
                alpha_filtering=1, alpha_quality=100, exact=0)


def pillow_libwebp() -> str:
    """The libwebp Pillow bundles (pillow.libs/libwebp-*.so.7.2.0)."""
    import PIL

    found = glob.glob(os.path.join(os.path.dirname(os.path.dirname(
        PIL.__file__)), "pillow.libs", "libwebp-*.so.7.2.0"))
    if not found:
        raise RuntimeError("Pillow bundles no libwebp 1.6 here")
    return found[0]


@functools.cache
def _writer():
    """tests/torch_webp_writer.c built against Pillow's libwebp into
    build/tests (named by a digest of the source and the library)."""
    lib_path = pillow_libwebp()
    with open(WRITER_SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read() + lib_path.encode()).hexdigest()[:16]
    path = os.path.join(jcorpus.WRITER_DIR, f"libwebp_writer_{tag}.so")
    if not os.path.isfile(path):
        os.makedirs(jcorpus.WRITER_DIR, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-o", tmp,
                        WRITER_SOURCE, lib_path,
                        f"-Wl,-rpath,{os.path.dirname(lib_path)}"],
                       check=True, capture_output=True)
        os.replace(tmp, path)
    from PIL import _webp  # noqa: F401  (loads libwebp's own dependencies)

    lib = ctypes.CDLL(path)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ww_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(u8p),
                              ctypes.POINTER(ctypes.c_size_t)]
    lib.ww_encode.restype = ctypes.c_int
    lib.ww_free.argtypes = [u8p]
    lib.ww_free.restype = None
    return lib


def encode(arr: np.ndarray, **settings) -> bytes:
    """A RIFF WebP of arr ((h, w, 3) or (h, w, 4) uint8) written by
    libwebp 1.6.0 with DEFAULTS overridden by settings."""
    cfg = dict(DEFAULTS, **settings)
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w, c = arr.shape
    rgba = arr if c == 4 else np.concatenate(
        [arr, np.full((h, w, 1), 255, np.uint8)], -1)
    rgba = np.ascontiguousarray(rgba)
    values = (ctypes.c_int * len(SETTINGS))(*[int(cfg[k]) for k in SETTINGS])
    lib = _writer()
    buf, size = ctypes.POINTER(ctypes.c_uint8)(), ctypes.c_size_t()
    code = lib.ww_encode(jcorpus._u8p(rgba), h, w, int(c == 4), values,
                         ctypes.byref(buf), ctypes.byref(size))
    if code:
        raise RuntimeError(f"libwebp refused the picture ({code}): {cfg}")
    try:
        return ctypes.string_at(buf, size.value)
    finally:
        lib.ww_free(buf)


def pil(arr: np.ndarray, **kw) -> bytes:
    """Pillow's own WebP writer."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "WEBP", **kw)
    return buf.getvalue()


def picture(seed: int, h: int, w: int, channels: int = 3) -> np.ndarray:
    return jcorpus.picture(seed, h, w, channels)


def with_alpha(rgb: np.ndarray, seed: int) -> np.ndarray:
    """rgb with an alpha plane of ramps, a hole and a few random values."""
    h, w = rgb.shape[:2]
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = (xx * 255 // max(w - 1, 1) + yy * 3) % 256
    a[h // 3:2 * h // 3 + 1, w // 3:2 * w // 3 + 1] = 0
    a[rng.random((h, w)) < 0.05] = rng.integers(0, 256)
    return np.concatenate([rgb, a[..., None].astype(np.uint8)], -1)


def palette_picture(seed: int, h: int, w: int, colors: int) -> np.ndarray:
    """(h, w, 3) uint8 using exactly `colors` colours (h * w >= colors)."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 256, (colors, 3)).astype(np.uint8)
    table[:, 0] = np.arange(colors) % 256       # distinct entries
    idx = (picture(seed, h, w)[..., 0].astype(np.int64) * colors) // 256
    idx.reshape(-1)[:colors] = np.arange(colors)
    return table[idx]


# -- the container ------------------------------------------------------------

def chunk(fourcc: bytes, payload: bytes, size=None) -> bytes:
    """A RIFF chunk, padded to an even length (size overrides the header)."""
    n = len(payload) if size is None else size
    return fourcc + struct.pack("<I", n) + payload + b"\0" * (len(payload) & 1)


def riff(body: bytes, size=None) -> bytes:
    n = 4 + len(body) if size is None else size
    return b"RIFF" + struct.pack("<I", n) + b"WEBP" + body


def chunks(data: bytes) -> list:
    """[(fourcc, payload)] of a RIFF WebP's top-level chunks."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        n = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def image_chunks(data: bytes) -> bytes:
    """The ALPH (if any) and VP8/VP8L chunks of a still file, as bytes."""
    return b"".join(chunk(t, p) for t, p in chunks(data)
                    if t in (b"ALPH", b"VP8 ", b"VP8L"))


def vp8x(flags: int, w: int, h: int, size: int = 10) -> bytes:
    payload = struct.pack("<I", flags)[:4] + (w - 1).to_bytes(3, "little") + \
        (h - 1).to_bytes(3, "little")
    return chunk(b"VP8X", payload + b"\0" * (size - 10))


def anmf(x: int, y: int, w: int, h: int, frame: bytes) -> bytes:
    """An ANMF chunk of frame (ALPH and VP8/VP8L chunks) at (x, y), even."""
    head = b"".join(v.to_bytes(3, "little")
                    for v in (x // 2, y // 2, w - 1, h - 1, 100))
    return chunk(b"ANMF", head + b"\x00" + frame)


def animation(canvas, frames, alpha: bool = True) -> bytes:
    """A RIFF animation: frames are (x, y, w, h, frame chunks)."""
    body = vp8x(0x02 | (0x10 if alpha else 0), *canvas) + \
        chunk(b"ANIM", b"\xff\xff\xff\xff\x00\x00")
    return riff(body + b"".join(anmf(*f) for f in frames))


def alpha_filtered(a: np.ndarray, method: int) -> np.ndarray:
    """The deltas of libwebp's alpha filters (1 horizontal, 2 vertical,
    3 gradient; 0 none) of an (h, w) uint8 plane."""
    a = a.astype(np.int32)
    h, w = a.shape
    pred = np.zeros_like(a)
    if method:
        pred[0, 1:] = a[0, :-1]                  # the first row: the left
        pred[1:, 0] = a[:-1, 0]                  # the first column: above
        if method == 1:
            pred[1:, 1:] = a[1:, :-1]
        elif method == 2:
            pred[1:, 1:] = a[:-1, 1:]
        else:
            pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0,
                                   255)
    return ((a - pred) % 256).astype(np.uint8)


def alph(a: np.ndarray, compressed: bool, method: int,
         header: int = None) -> bytes:
    """An ALPH chunk of an (h, w) plane: raw, or VP8L-coded (the deltas as
    the green of a lossless image, its 5-byte header dropped)."""
    deltas = alpha_filtered(a, method)
    if header is None:
        header = int(compressed) | method << 2
    if compressed:
        h, w = a.shape
        img = np.zeros((h, w, 3), np.uint8)
        img[..., 1] = deltas
        stream = dict(chunks(encode(img, lossless=1, quality=100,
                                    method=4)))[b"VP8L"][5:]
    else:
        stream = deltas.tobytes()
    return chunk(b"ALPH", bytes([header]) + stream)


def still_with_alpha(vp8_payload: bytes, w: int, h: int, alpha_chunk: bytes,
                     flags: int = 0x10) -> bytes:
    return riff(vp8x(flags, w, h) + alpha_chunk + chunk(b"VP8 ", vp8_payload))


def vp8_payload(data: bytes) -> bytes:
    return dict(chunks(data))[b"VP8 "]


# -- VP8L streams written by hand ---------------------------------------------
#
# libwebp's encoder never writes a palette index past the palette, or a
# plane code whose distance falls below 1 on a narrow image; these streams
# do, with the smallest codes the format has.

class _BitWriter:
    """Bits LSB first, as VP8L reads them."""

    def __init__(self):
        self.value, self.count = 0, 0

    def put(self, value: int, n: int):
        self.value |= value << self.count
        self.count += n

    def bytes(self) -> bytes:
        return self.value.to_bytes((self.count + 7) // 8, "little")


def _simple_code(bw: _BitWriter, symbols):
    """A simple prefix code of one or two symbols below 256."""
    bw.put(1, 1)
    bw.put(len(symbols) - 1, 1)
    bw.put(1, 1)                                 # an 8-bit first symbol
    for s in symbols:
        bw.put(s, 8)


def _two_symbol_code(bw: _BitWriter, alphabet: int, symbols):
    """A normal prefix code giving two symbols length 1, through a code-
    length code of the lengths 0 and 1."""
    bw.put(0, 1)
    bw.put(0, 4)                                 # 4 code-length codes
    for length in (0, 0, 1, 1):                  # for 17, 18, 0, 1
        bw.put(length, 3)
    bw.put(0, 1)                                 # every symbol's length
    for s in range(alphabet):
        bw.put(int(s in symbols), 1)


def _vp8l_header(bw: _BitWriter, w: int, h: int):
    bw.put(0x2f, 8)
    bw.put(w - 1, 14)
    bw.put(h - 1, 14)
    bw.put(0, 1)
    bw.put(0, 3)


def vp8l_past_palette() -> bytes:
    """A 20 x 3 VP8L file through a palette of 17 colours whose indices are
    0 and 200: index 200 reads libwebp's zero-filled map (transparent
    black)."""
    bw = _BitWriter()
    _vp8l_header(bw, 20, 3)
    bw.put(1, 1)
    bw.put(3, 2)                                 # colour indexing
    bw.put(16, 8)                                # 17 colours
    bw.put(0, 1)                                 # the palette: no cache
    for value in (37, 90, 11, 255, 0):           # green, red, blue, alpha
        _simple_code(bw, [value])
    bw.put(0, 1)                                 # no transform more
    bw.put(0, 1)                                 # no cache
    bw.put(0, 1)                                 # no meta codes
    _simple_code(bw, [0, 200])
    for value in (0, 0, 0, 0):
        _simple_code(bw, [value])
    for i in range(60):
        bw.put(int(i % 3 == 1 or i % 7 == 0), 1)
    return riff(chunk(b"VP8L", bw.bytes()))


def vp8l_plane_distance_one() -> bytes:
    """A 1 x 5 VP8L file of a literal and four copies at plane code 4
    (x -1, y 1): a distance of 0 on a 1-pixel-wide image, read as 1."""
    bw = _BitWriter()
    _vp8l_header(bw, 1, 5)
    bw.put(0, 1)                                 # no transforms
    bw.put(0, 1)                                 # no cache
    bw.put(0, 1)                                 # no meta codes
    _two_symbol_code(bw, 280, {77, 256})         # a literal, length 1
    for value in (20, 140, 255):
        _simple_code(bw, [value])
    _simple_code(bw, [3])                        # distance symbol 3: code 4
    bw.put(0, 1)
    for _ in range(4):
        bw.put(1, 1)
    return riff(chunk(b"VP8L", bw.bytes()))


def alpha_past_end(w: int, h: int):
    """An ALPH payload (VP8L-coded, unfiltered) for a w x h frame through a
    2-colour palette, whose last symbol lies one bit past the end of the
    data: libwebp's 8-bit alpha path keeps such a plane (the bit comes from
    its wrapped window), where any other stream end is an error. None
    where the stream's length leaves no such cut at this size."""
    bw = _BitWriter()
    bw.put(1, 1)
    bw.put(3, 2)                                 # colour indexing
    bw.put(1, 8)                                 # 2 colours: 8 a byte
    bw.put(0, 1)
    for value in (100, 0, 0, 0, 0):
        _simple_code(bw, [value])
    bw.put(0, 1)                                 # no transform more
    bw.put(0, 1)                                 # no cache
    bw.put(0, 1)                                 # no meta codes
    _simple_code(bw, [0, 255])
    for value in (0, 0, 0, 0):
        _simple_code(bw, [value])
    packed = (w + 7) // 8 * h
    if (bw.count + packed - 1) % 8:
        return None
    for i in range(packed):
        bw.put(int(i % 5 == 2) if i < packed - 1 else 0, 1)
    stream = bw.bytes()[:(bw.count - 1) // 8]
    return bytes([1]) + stream


# -- headers, read back for the coverage checks -------------------------------

class _BoolDecoder:
    """RFC 6386's boolean decoder, for reading VP8 frame headers."""

    def __init__(self, data: bytes):
        self.data, self.pos = data + b"\0" * 4, 2
        self.value = data[0] << 8 | data[1]
        self.range, self.count = 255, 0

    def bit(self, prob: int = 128) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if self.value >= split << 8:
            out, self.range, self.value = 1, self.range - split, \
                self.value - (split << 8)
        else:
            out, self.range = 0, split
        while self.range < 128:
            self.value, self.range = self.value << 1, self.range << 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                self.value |= self.data[self.pos]
                self.pos += 1
        return out

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = v << 1 | self.bit()
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit() else v


def vp8_header(payload: bytes) -> dict:
    """The loop filter, segments and token partitions of a VP8 payload."""
    d = _BoolDecoder(payload[10:])
    d.literal(2)                                 # colour space, clamping
    segments = d.bit()
    if segments:
        update_map, update_data = d.bit(), d.bit()
        if update_data:
            d.bit()
            for n in (7, 7, 7, 7, 6, 6, 6, 6):
                if d.bit():
                    d.signed(n)
        if update_map:
            for _ in range(3):
                if d.bit():
                    d.literal(8)
    simple, level, sharpness = d.bit(), d.literal(6), d.literal(3)
    if d.bit() and d.bit():
        for _ in range(8):
            if d.bit():
                d.signed(6)
    return {"simple": simple, "level": level, "sharpness": sharpness,
            "segments": segments, "partitions": 1 << d.literal(2)}


def vp8l_palette(payload: bytes):
    """The colour count of a VP8L stream whose first transform is colour
    indexing, else None."""
    bits = int.from_bytes(payload[5:9], "little")
    if not bits & 1 or (bits >> 1) & 3 != 3:
        return None
    return ((bits >> 3) & 0xff) + 1


# -- the cases ----------------------------------------------------------------

def searched(seed: int, **settings) -> bytes:
    """A lossy file of the seeded search that found the files pinning a
    rule no plainer file reaches (a filter level at a hev threshold, a 4x4
    block reading the top-right of the last macroblock column, the y2 AC
    clamp): the search's size, picture and settings for that seed."""
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(17, 68)), int(rng.integers(17, 68))
    arr = picture(seed, h, w)
    if seed % 3 == 0:
        arr = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    return encode(arr, **settings)


def _lossy_cases(out: dict):
    pic = picture(11, 67, 67)
    for s in range(8):
        out[f"lossy_normal_sharp{s}_67x67.webp"] = encode(
            pic, filter_sharpness=s, filter_strength=70, quality=40)
    for s in (0, 3, 7):
        out[f"lossy_simple_sharp{s}_67x67.webp"] = encode(
            pic, filter_type=0, filter_sharpness=s, filter_strength=70,
            quality=40)
    out["lossy_level0_67x67.webp"] = encode(pic, filter_strength=0)
    out["lossy_level63_67x67.webp"] = encode(pic, filter_strength=100,
                                             quality=0, filter_sharpness=0)
    out["lossy_simple_level63_67x67.webp"] = encode(
        pic, filter_type=0, filter_strength=100, quality=0)
    for p in range(4):                  # libwebp splits tokens at method 0
        out[f"lossy_partitions{1 << p}_67x67.webp"] = encode(
            pic, partitions=p, method=0)
    out["lossy_partitions8_rows3_83x41.webp"] = encode(
        picture(12, 41, 83), partitions=3, method=0)
    for s in range(1, 5):
        out[f"lossy_segments{s}_67x67.webp"] = encode(pic, segments=s,
                                                      sns_strength=100)
    for m in range(7):
        out[f"lossy_method{m}_45x39.webp"] = encode(picture(20 + m, 39, 45),
                                                    method=m, quality=60)
    for q in (0, 100):
        out[f"lossy_q{q}_33x31.webp"] = encode(picture(30, 31, 33), quality=q)
    out["lossy_sns0_33x31.webp"] = encode(picture(31, 31, 33), sns_strength=0)
    for h, w in ((1, 1), (2, 2), (5, 3), (16, 16), (17, 17), (8, 65),
                 (65, 9), (32, 48)):
        out[f"lossy_{w}x{h}.webp"] = encode(picture(40 + h + w, h, w),
                                            quality=50)
    out["pillow_lossy_53x37.webp"] = pil(picture(50, 37, 53), quality=80)
    out["lossy_top_right_48x65.webp"] = searched(
        7, quality=69, filter_strength=58, sns_strength=78, method=5,
        segments=1)
    out["lossy_y2_clamp_65x22.webp"] = searched(
        318, quality=100, filter_strength=6, sns_strength=7, method=2,
        segments=4)
    out["lossy_hev_level43_26x50.webp"] = searched(
        403, quality=7, filter_strength=74, sns_strength=27, method=6,
        segments=4)
    out["lossy_hev_level40_29x50.webp"] = searched(
        1296, quality=17, filter_strength=71, sns_strength=56, method=1,
        segments=4)
    # four token bytes overwritten: coefficients past the 16 bits of
    # libwebp's SSE2 inverse transform, which wraps where its C does not
    # (a chroma block at 496, a luma block at 577)
    for at, patch in ((496, b"\x91\x7a\x28\x9c"), (577, b"\x82\xac\x82\xfb")):
        wrap = bytearray(out["lossy_hev_level40_29x50.webp"])
        wrap[at:at + 4] = patch
        out[f"lossy_sse2_wrap{at}_29x50.webp"] = bytes(wrap)


def _alpha_cases(out: dict):
    rgba = with_alpha(picture(60, 37, 53), 60)
    for comp in (0, 1):
        for filt in (0, 1, 2):
            out[f"alpha_writer_c{comp}_f{filt}_53x37.webp"] = encode(
                rgba, alpha_compression=comp, alpha_filtering=filt)
    out["alpha_writer_q40_53x37.webp"] = encode(rgba, alpha_quality=40)
    out["alpha_writer_exact_53x37.webp"] = encode(rgba, exact=1)
    out["pillow_alpha_53x37.webp"] = pil(rgba, quality=70)
    payload = vp8_payload(encode(rgba[..., :3], quality=70))
    a = rgba[..., 3]
    for comp in (0, 1):
        for method in range(4):
            out[f"alph_c{comp}_filter{method}_53x37.webp"] = \
                still_with_alpha(payload, 53, 37, alph(a, comp, method))
    h = next(h for h in range(30, 60) if alpha_past_end(53, h) is not None)
    out[f"alph_past_end_53x{h}.webp"] = still_with_alpha(
        vp8_payload(encode(picture(61, h, 53), quality=70)), 53, h,
        chunk(b"ALPH", alpha_past_end(53, h)))
    out["alph_no_flag_53x37.webp"] = still_with_alpha(
        payload, 53, 37, alph(a, 1, 3), flags=0)
    # without the VP8X alpha flag the demuxer drops the ALPH chunk, bad or not
    out["alph_bad_no_flag_53x37.webp"] = still_with_alpha(
        payload, 53, 37, alph(a, 0, 0, header=0x40), flags=0)
    # refused: reserved bits, a method past 1, a raw plane cut short, a
    # coded stream cut short, an empty chunk
    out["bad_alph_reserved_53x37.webp"] = still_with_alpha(
        payload, 53, 37, alph(a, 0, 0, header=0x40))
    out["bad_alph_method2_53x37.webp"] = still_with_alpha(
        payload, 53, 37, alph(a, 0, 0, header=0x02))
    raw = dict(chunks(still_with_alpha(payload, 53, 37,
                                       alph(a, 0, 1))))[b"ALPH"]
    out["bad_alph_short_53x37.webp"] = still_with_alpha(
        payload, 53, 37, chunk(b"ALPH", raw[:-1]))
    coded = dict(chunks(still_with_alpha(payload, 53, 37,
                                         alph(a, 1, 2))))[b"ALPH"]
    out["bad_alph_coded_cut_53x37.webp"] = still_with_alpha(
        payload, 53, 37, chunk(b"ALPH", coded[:len(coded) // 2]))
    out["bad_alph_empty_53x37.webp"] = still_with_alpha(
        payload, 53, 37, chunk(b"ALPH", b""))


def _lossless_cases(out: dict):
    for colors, (w, h) in ((2, (37, 29)), (3, (35, 17)), (4, (37, 29)),
                           (5, (31, 23)), (16, (37, 29)), (17, (21, 19)),
                           (256, (53, 37))):
        out[f"lossless_palette{colors}_{w}x{h}.webp"] = pil(
            palette_picture(colors, h, w, colors), lossless=True)
    for m in range(7):
        out[f"lossless_method{m}_45x39.webp"] = pil(
            picture(70 + m, 39, 45), lossless=True, method=m, quality=m * 16)
    out["lossless_q0_61x47.webp"] = pil(picture(80, 47, 61), lossless=True,
                                        quality=0)
    out["lossless_q100_61x47.webp"] = pil(picture(81, 47, 61), lossless=True,
                                          quality=100, method=6)
    rgba = with_alpha(picture(82, 37, 53), 82)
    out["lossless_alpha_53x37.webp"] = pil(rgba, lossless=True)
    out["lossless_alpha_exact_53x37.webp"] = pil(rgba, lossless=True,
                                                 exact=True)
    out["lossless_1x1.webp"] = pil(picture(83, 1, 1), lossless=True)
    out["lossless_gray_64x64.webp"] = pil(
        np.repeat(picture(84, 64, 64)[..., :1], 3, -1), lossless=True)
    out["lossless_writer_67x67.webp"] = encode(picture(85, 67, 67),
                                               lossless=1, quality=50)
    out["vp8l_past_palette_20x3.webp"] = vp8l_past_palette()
    out["vp8l_plane_distance_1x5.webp"] = vp8l_plane_distance_one()


def _container_cases(out: dict):
    lossy = encode(picture(90, 20, 26), quality=60)
    lossless = pil(with_alpha(picture(91, 14, 18), 91), lossless=True)
    alpha_lossy = encode(with_alpha(picture(92, 12, 16), 92))
    out["anim_offset_vp8_40x30.webp"] = animation(
        (40, 30), [(8, 6, 26, 20, image_chunks(lossy)),
                   (0, 0, 18, 14, image_chunks(lossless))])
    out["anim_offset_vp8l_40x30.webp"] = animation(
        (40, 30), [(12, 10, 18, 14, image_chunks(lossless))])
    out["anim_offset_alph_40x30.webp"] = animation(
        (40, 30), [(22, 16, 16, 12, image_chunks(alpha_lossy))])
    out["anim_anmf_size_mismatch_40x30.webp"] = animation(
        (40, 30), [(2, 2, 30, 24, image_chunks(lossy))])
    from PIL import Image

    frames = [Image.fromarray(picture(93 + i, 24, 32)) for i in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   duration=50, lossless=False, quality=60)
    out["pillow_anim_32x24.webp"] = buf.getvalue()
    still = pil(picture(94, 21, 27), quality=70)
    body = chunks(still)
    vp8 = chunk(b"VP8 ", dict(body)[b"VP8 "])
    out["extended_icc_exif_27x21.webp"] = riff(
        vp8x(0x28, 27, 21) + chunk(b"ICCP", b"\0" * 13) + vp8 +
        chunk(b"EXIF", b"Exif\0\0MM"))
    out["extended_unknown_chunk_27x21.webp"] = riff(
        vp8x(0, 27, 21) + chunk(b"ABCD", b"xyz") + vp8)
    out["trailing_bytes_27x21.webp"] = still + b"trailing garbage"
    out["simple_trailing_chunk_27x21.webp"] = riff(vp8 + chunk(b"ABCD",
                                                               b"12"))
    # refused
    out["bad_vp8x_size12_27x21.webp"] = riff(vp8x(0, 27, 21, 12) + vp8)
    out["bad_riff_size_big_27x21.webp"] = riff(vp8, size=len(vp8) + 14)
    out["bad_riff_size_small_27x21.webp"] = riff(vp8, size=len(vp8) - 6)
    out["bad_frame_outside_40x30.webp"] = animation(
        (40, 30), [(16, 12, 26, 20, image_chunks(lossy))])
    out["bad_frame_outside_x_40x30.webp"] = animation(
        (40, 30), [(16, 0, 26, 20, image_chunks(lossy))])
    out["bad_canvas_size_27x21.webp"] = riff(vp8x(0, 28, 21) + vp8)
    out["bad_bomb_16384x16384.webp"] = animation(
        (16384, 16384), [(0, 0, 26, 20, image_chunks(lossy))])
    out["bad_signature_27x21.webp"] = riff(chunk(
        b"VP8 ", dict(body)[b"VP8 "][:3] + b"\x9d\x01\x2b" +
        dict(body)[b"VP8 "][6:]))
    out["bad_anim_no_frames_27x21.webp"] = riff(
        vp8x(0x02, 27, 21) + chunk(b"ANIM", b"\0" * 6))
    big = encode(picture(95, 67, 67), quality=90, partitions=2)
    payload = vp8_payload(big)
    for keep in (len(payload) // 2, len(payload) - 40):
        out[f"bad_token_partition_{keep}_67x67.webp"] = riff(
            chunk(b"VP8 ", payload[:keep]))
    vl = dict(chunks(pil(picture(96, 29, 37), lossless=True)))[b"VP8L"]
    out["vp8l_one_byte_short_37x29.webp"] = riff(chunk(b"VP8L", vl[:-1]))
    out["vp8l_two_bytes_short_37x29.webp"] = riff(chunk(b"VP8L", vl[:-2]))
    for cut in (15, 30, 100, len(lossy) - 1):
        out[f"cut_{cut}_26x20.webp"] = lossy[:cut]


def scene_cases() -> dict:
    """The 640x480 scene lossy, lossless and lossy with alpha."""
    rgb = torch_jpeg_fixtures.scene(0)
    return {
        "scene_lossy_640x480.webp": pil(rgb, quality=80),
        "scene_lossless_640x480.webp": pil(rgb, lossless=True),
        "scene_alpha_640x480.webp": pil(with_alpha(rgb, 7), quality=80),
    }


def cases() -> dict:
    """{file name: bytes}."""
    out = {}
    _lossy_cases(out)
    _alpha_cases(out)
    _lossless_cases(out)
    _container_cases(out)
    out.update(scene_cases())
    return out


def load(folder: str = FOLDER) -> dict:
    with open(os.path.join(folder, DIGESTS)) as f:
        return json.load(f)


def write(folder: str = FOLDER) -> dict:
    """Write every case and digests.json into folder; returns the digests."""
    os.makedirs(folder, exist_ok=True)
    digests = {}
    for name, data in sorted(cases().items()):
        with open(os.path.join(folder, name), "wb") as f:
            f.write(data)
        digests[name] = reference(data)
    with open(os.path.join(folder, DIGESTS), "w") as f:
        f.write("{\n" + ",\n".join(
            f" {json.dumps(k)}: {json.dumps(v, sort_keys=True)}"
            for k, v in digests.items()) + "\n}\n")
    return digests


if __name__ == "__main__":
    print(json.dumps(write(*sys.argv[1:]), indent=1, sort_keys=True))
