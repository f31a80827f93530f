"""The raster formats that Pillow 12.1.0 both reads and writes, and two
readers built on them, as Pillow's plugins read them, then
``convert("RGB")``: DIB, ICO, CUR, PCX, DCX, MSP, QOI, SGI, SPIDER, TGA,
XBM and IM.

The JAX package hands every image that is not a JPEG to Pillow (the
server's and the loader's ``_decode_image``, detect ``--img``'s
``Image.open``, the dataset's ``_read_image_size``). This module is the
port's copy of what those plugins do. Each section is one plugin: its
``_open`` copied from Pillow's (the same reads over the file's bytes, so
that a short read fails as it fails there), and its load: Pillow's raw
decoder and unpackers in numpy, the byte loops of its C and Python
decoders (PCX, TGA and SGI RLE, MSP version 2, QOI, XBM, IM's bit-packed
floats) in ``csrc/raster_decode.cc``, DIB pixels in ``csrc/bmp_decode.cc``
(the BMP decoder, entered at the info header).

``open_format(fmt, data)`` runs a plugin's open: it returns an ``Opened``,
raises ``PassOn`` where Pillow's ``Image.open`` would try its next plugin
(the plugin raised SyntaxError, IndexError, TypeError, KeyError, EOFError
or struct.error, or left a size below 1), and ValueError where Pillow's
open fails outright (any other exception, the decompression-bomb limit).
``decode(data, opened, by_path)`` loads it and converts it to RGB, or
raises ValueError where Pillow's load fails. data/formats.py walks the
plugins in Pillow's order; data/native.py routes the files.
"""

from __future__ import annotations

import ctypes
import io
import math
import re
import struct
from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np

from yolov5m_tpu_torch.data import convert

MAX_PIXELS = 2 * 89478485          # twice PIL.Image.MAX_IMAGE_PIXELS
# what Image.open passes on: its own list (SyntaxError, IndexError,
# TypeError, struct.error) and what ImageFile.__init__ turns into
# SyntaxError out of a plugin's _open (KeyError, EOFError)
_PASSED_ON = (SyntaxError, IndexError, TypeError, KeyError, EOFError,
              struct.error)


class PassOn(Exception):
    """Pillow's plugin passes the file on: ``Image.open`` tries the next."""


class Opened(NamedTuple):
    fmt: str
    mode: str
    size: tuple                # (w, h), as Pillow's ``im.size`` (IM's
                               # header may give other than two ints)
    load: Callable             # load(data, by_path) -> (h, w, 3) uint8


def _i16le(c: bytes, o: int = 0) -> int:
    return struct.unpack_from("<H", c, o)[0]


def _i32le(c: bytes, o: int = 0) -> int:
    return struct.unpack_from("<I", c, o)[0]


def _i16be(c: bytes, o: int = 0) -> int:
    return struct.unpack_from(">H", c, o)[0]


def _i32be(c: bytes, o: int = 0) -> int:
    return struct.unpack_from(">I", c, o)[0]


def _safe_read(fp, size: int) -> bytes:
    """ImageFile._safe_read: OSError where the file holds fewer bytes."""
    if size <= 0:
        return b""
    data = fp.read(size)
    if len(data) < size:
        raise OSError("Truncated File Read")
    return data


def _lib():
    from yolov5m_tpu_torch.data import native
    return native.decode_lib()


def _ptr(a: np.ndarray):
    from yolov5m_tpu_torch.data import native
    return native._as_u8p(a)


def _buf(data) -> np.ndarray:
    return np.frombuffer(data, np.uint8)


# -- Image.open's checks ------------------------------------------------------

class _File(io.BytesIO):
    """The file Pillow's open reads: a stream of the bytes (the server's
    BytesIO), or the file at a path, whose seek before its start fails
    (Python's BytesIO stops at 0 there)."""

    def __init__(self, data: bytes, by_path: bool):
        super().__init__(data)
        self.by_path = by_path
        self.size = len(data)

    def seek(self, pos: int, whence: int = 0) -> int:
        if self.by_path and whence == io.SEEK_END and self.size + pos < 0:
            raise OSError(22, "Invalid argument")
        return super().seek(pos, whence)


def open_format(fmt: str, data, by_path: bool = False) -> Opened:
    """Run plugin fmt's open on data as ``Image.open`` runs it: PassOn where
    Pillow would try its next plugin, ValueError where its open fails.
    by_path: Pillow opens the file by its path (a seek before its start
    fails there)."""
    data = bytes(data)
    try:
        opened = OPENERS[fmt](_File(data, by_path))
        size = opened.size
        if not opened.mode or size[0] <= 0 or size[1] <= 0:
            raise SyntaxError("no mode, or a size below 1")
    except _PASSED_ON as e:
        raise PassOn(str(e)) from None
    except ValueError:
        raise
    except Exception as e:  # Image.open re-raises every other error
        raise ValueError(f"{fmt}: {type(e).__name__}: {e}") from None
    if max(1, size[0]) * max(1, size[1]) > MAX_PIXELS:
        raise ValueError("decompression bomb")
    return opened


def decode(data, opened: Opened, by_path: bool = False) -> np.ndarray:
    """(h, w, 3) uint8 as ``convert("RGB")`` gives the loaded image;
    ValueError where Pillow's load fails."""
    try:
        img = opened.load(bytes(data), by_path)
    except ValueError:
        raise
    except Exception as e:  # every load failure refuses the file
        raise ValueError(f"{opened.fmt}: {type(e).__name__}: {e}") from None
    return img


def _whole(size) -> Tuple[int, int]:
    """A size Pillow's load can allocate: two ints (IM's header can give
    floats or more values, which its load refuses)."""
    if not (isinstance(size, tuple) and len(size) == 2 and
            all(type(v) is int for v in size)):
        raise ValueError("the image size is not two integers")
    return size


# -- Pillow's raw decoder and unpackers ---------------------------------------

# rawmode -> bits a pixel (Unpack.c's table for the modes used here)
_BITS = {"1": 1, "1;R": 1, "1;I": 1, "L": 8, "P": 8, "P;2": 2, "P;4": 4,
         "P;2L": 2, "P;4L": 4, "LA": 16, "RGB": 24, "BGR": 24, "BGRX": 32,
         "BGRA": 32, "BGRA;15Z": 16, "RGB;L": 24, "RGBX;L": 32,
         "RGBA;L": 32, "CMYK;L": 32, "LA;L": 16, "PA;L": 16,
         "YCbCr;L": 24,
         "R": 8, "G": 8, "B": 8, "A": 8, "I;16": 16, "I;16L": 16,
         "I;16B": 16, "I;32": 32, "I;32S": 32, "F;8": 8, "F;8S": 8,
         "F;16": 16, "F;16S": 16, "F;16B": 16, "F;32": 32, "F;32S": 32,
         "F;32F": 32, "F;32BF": 32, "L;16B": 16, "RGB;16B": 48,
         "RGBA;16B": 64}
# (mode, rawmode) pairs Pillow has an unpacker for, among these rawmodes
# (Image.frombytes over every pair: the same pairs, no others)
_UNPACKERS = {
    "1": {"1", "1;I", "1;R"}, "L": {"L", "L;16B"},
    "P": {"L", "P", "P;2", "P;2L", "P;4", "P;4L"}, "LA": {"LA", "LA;L"},
    "PA": {"LA", "PA;L"},
    "RGB": {"B", "BGR", "BGRX", "G", "R", "RGB", "RGB;16B", "RGB;L",
            "RGBA;L", "RGBX;L"},
    "RGBA": {"A", "B", "BGR", "BGRA", "BGRA;15Z", "G", "LA", "R",
             "RGBA;16B", "RGBA;L"},
    "RGBX": {"B", "BGR", "BGRX", "G", "R", "RGB", "RGB;16B", "RGB;L",
             "RGBX;L"},
    "CMYK": {"CMYK;L"}, "YCbCr": {"YCbCr;L"}, "LAB": {"A", "B", "L"},
    "I": {"I;16", "I;16B", "I;32", "I;32S"}, "I;16": {"I;16", "I;16B"},
    "I;16L": {"I;16L"}, "I;16B": {"I;16B"},
    "F": {"F;16", "F;16B", "F;16S", "F;32", "F;32BF", "F;32F", "F;32S",
          "F;8", "F;8S"},
}


def unpacker_bits(mode: str, rawmode: str) -> int:
    """The unpacker's bits a pixel; ValueError where Pillow has none for
    (mode, rawmode) ("unknown raw mode for given image mode")."""
    if rawmode not in _UNPACKERS.get(mode, ()):
        raise ValueError(f"unknown raw mode {rawmode} for {mode}")
    return _BITS[rawmode]


def raw_rows(data: bytes, offset: int, size: Tuple[int, int], bits: int,
             stride: int = 0, ystep: int = 1) -> np.ndarray:
    """Pillow's raw decoder: (h, row bytes) in image row order; each row
    needs its bytes, the padding to stride only between rows. ValueError
    where the file holds too few ("image file is truncated")."""
    w, h = size
    row = (w * bits + 7) // 8
    if stride and stride < row:
        raise ValueError("stride shorter than a row")
    pitch = stride or row
    if offset < 0:
        raise ValueError("negative seek value")
    if len(data) < offset + (h - 1) * pitch + row:
        raise ValueError("image file is truncated")
    buf = _buf(data)
    rows = np.lib.stride_tricks.as_strided(
        buf[offset:], (h, row), (pitch, 1)).copy() if h else \
        np.zeros((0, row), np.uint8)
    return rows[::-1] if ystep < 0 else rows


def _bits_msb(rows: np.ndarray, w: int, n: int) -> np.ndarray:
    """n-bit values (n 2 or 4), most significant first in each byte."""
    shifts = np.arange(8 - n, -1, -n, dtype=np.uint8)
    v = (rows[..., None] >> shifts) & ((1 << n) - 1)
    return v.reshape(rows.shape[0], -1)[:, :w]


def unpack(mode: str, rawmode: str, rows: np.ndarray, w: int) -> np.ndarray:
    """Samples of mode, (h, w) or (h, w, bands), from rows of rawmode as
    Pillow's unpacker gives them."""
    h = rows.shape[0]
    if rawmode in ("1", "1;I", "1;R"):
        if rawmode == "1;R":
            bits = np.unpackbits(rows, axis=1, bitorder="little")[:, :w]
        else:
            bits = np.unpackbits(rows, axis=1)[:, :w]
        if rawmode == "1;I":
            bits = 1 - bits
        return bits * np.uint8(255)
    if rawmode in ("L", "P", "R", "G", "B", "A"):
        if mode == "LAB":              # one band; the others stay 0
            out = np.zeros((h, w, 3), np.uint8)
            out[..., "LAB".index(rawmode)] = rows[:, :w]
            return out
        return rows[:, :w]
    if rawmode in ("P;2", "P;4"):
        return _bits_msb(rows, w, int(rawmode[2]))
    if rawmode in ("P;2L", "P;4L"):
        planes = int(rawmode[2])
        s = (w + 7) // 8
        out = np.zeros((h, w), np.uint8)
        for p in range(planes):
            bits = np.unpackbits(rows[:, p * s:(p + 1) * s], axis=1)[:, :w]
            out |= bits << p
        return out
    if rawmode in ("LA", "BGR", "RGB", "BGRX", "BGRA"):
        n = {"LA": 2, "BGR": 3, "RGB": 3, "BGRX": 4, "BGRA": 4}[rawmode]
        px = rows[:, :w * n].reshape(h, w, n)
        if rawmode == "LA" and mode == "RGBA":     # L, L, L, A
            return px[..., [0, 0, 0, 1]]
        if rawmode in ("BGR", "BGRX", "BGRA"):
            px = px[..., [2, 1, 0] + ([3] if n == 4 else [])]
        return px
    if rawmode == "BGRA;15Z":
        p = rows[:, :2 * w].reshape(h, w, 2).astype(np.int32)
        p = p[..., 0] | p[..., 1] << 8
        out = np.stack([(p >> 10 & 31) * 255 // 31, (p >> 5 & 31) * 255 // 31,
                        (p & 31) * 255 // 31,
                        np.where(p >> 15, 255, 0)], -1)
        return out.astype(np.uint8)
    if rawmode.endswith(";L"):           # bands one after another in a row
        n = _BITS[rawmode] // 8
        return np.ascontiguousarray(
            rows[:, :w * n].reshape(h, n, w).transpose(0, 2, 1))
    if rawmode in ("L;16B", "RGB;16B", "RGBA;16B"):
        n = _BITS[rawmode] // 16
        return rows[:, :2 * n * w].reshape(h, w, n, 2)[..., 0]
    dtype = {"I;16": "<u2", "I;16L": "<u2", "I;16B": ">u2", "I;32": "<i4",
             "I;32S": "<i4", "F;8": "u1", "F;8S": "i1", "F;16": "<u2",
             "F;16S": "<i2", "F;16B": ">u2", "F;32": "<u4", "F;32S": "<i4",
             "F;32F": "<f4", "F;32BF": ">f4"}[rawmode]
    k = np.dtype(dtype).itemsize
    v = np.frombuffer(rows[:, :k * w].tobytes(), dtype).reshape(h, w)
    if mode == "F":
        return v.astype(np.float32)
    return v.astype(np.int64)


def _rgb_l(rgb: bytes) -> bytes:
    """An "RGB" palette's bytes (r, g, b an entry) as RGB;L bytes (all
    reds, then greens, then blues), convert.to_rgb's palette layout."""
    return np.frombuffer(rgb, np.uint8).reshape(-1, 3).T.tobytes()


# -- DIB (BmpImagePlugin.DibImageFile) ----------------------------------------

DIB_SIZES = (12, 40, 52, 56, 64, 108, 124)
_BIT2MODE = {1: "P", 4: "P", 8: "P", 16: "RGB", 24: "RGB", 32: "RGB"}


def dib_accepts(prefix: bytes) -> bool:
    return _i32le(prefix) in DIB_SIZES


def _bitmap(fp, header: int = 0) -> Tuple[int, int, int]:
    """BmpImageFile._bitmap's reads and checks, as far as its errors go;
    the pixels are csrc/bmp_decode.cc's. Returns (w, h, the pixel data's
    offset)."""
    read = fp.read
    if header:
        fp.seek(header)
    header_size = _i32le(read(4))
    header_data = _safe_read(fp, header_size - 4)
    masks = None
    if header_size == 12:
        width, height = _i16le(header_data, 0), _i16le(header_data, 2)
        bits = _i16le(header_data, 6)
        compression, colors = 0, 0
    elif header_size in (40, 52, 56, 64, 108, 124):
        y_flip = header_data[7] == 0xFF
        width = _i32le(header_data, 0)
        height = _i32le(header_data, 4) if not y_flip else \
            2 ** 32 - _i32le(header_data, 4)
        bits = _i16le(header_data, 10)
        compression = _i32le(header_data, 12)
        colors = _i32le(header_data, 28)
        if compression == 3:
            if len(header_data) >= 48:
                masks = [_i32le(header_data, 36 + 4 * i) for i in
                         range(4 if len(header_data) >= 52 else 3)]
            else:
                masks = [_i32le(read(4)) for _ in range(3)]
            masks += [0] * (4 - len(masks))
    else:
        raise OSError(f"Unsupported BMP header type ({header_size})")
    colors = colors if colors else 1 << bits
    if bits not in _BIT2MODE:
        raise OSError(f"Unsupported BMP pixel depth ({bits})")
    if compression == 3:
        ok = {32: [(0xFF0000, 0xFF00, 0xFF, 0x0),
                   (0xFF000000, 0xFF0000, 0xFF00, 0x0),
                   (0xFF000000, 0xFF00, 0xFF, 0x0),
                   (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                   (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                   (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                   (0xFF000000, 0xFF00, 0xFF, 0xFF0000),
                   (0x0, 0x0, 0x0, 0x0)],
              24: [(0xFF0000, 0xFF00, 0xFF)],
              16: [(0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)]}
        if not ((bits == 32 and tuple(masks) in ok[32]) or
                (bits in (24, 16) and tuple(masks[:3]) in ok[bits])):
            raise OSError("Unsupported BMP bitfields layout")
    elif compression not in (0, 1, 2):
        raise OSError(f"Unsupported BMP compression ({compression})")
    if _BIT2MODE[bits] == "P":
        if not 0 < colors <= 65536:
            raise OSError(f"Unsupported BMP Palette size ({colors})")
        read((3 if header_size == 12 else 4) * colors)
    return width, height, fp.tell()


def _dib_pixels(data: bytes, header: int, halve: int) -> np.ndarray:
    """csrc/bmp_decode.cc's DIB entry: the info header at header, the
    pixel data after it (and its palette or masks), the height halved
    (ICO and CUR: the XOR image) where halve."""
    from yolov5m_tpu_torch.data import native

    lib = native.decode_lib()
    img = native._decode(lib.dib_dims, lib.decode_dib_u8, _buf(data), header,
                         halve)
    if img is None:
        raise ValueError("DIB refused")
    return img


def _open_dib(fp) -> Opened:
    w, h, _ = _bitmap(fp)
    return Opened("DIB", "RGB", (w, h),
                  lambda data, by_path: _dib_pixels(data, 0, 0))


# -- ICO (IcoImagePlugin) -----------------------------------------------------

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def ico_accepts(prefix: bytes) -> bool:
    return prefix.startswith(b"\0\0\1\0")


def _ico_frame(data: bytes, offset: int, size: int, bpp: int):
    """IcoFile.frame, then the image's load: (w, h) and the RGB pixels."""
    from yolov5m_tpu_torch.data import native

    fp = io.BytesIO(data)
    fp.seek(offset)
    if fp.read(8) == _PNG_MAGIC:
        png = data[offset:]
        hw = native.png_dims(png)
        if hw is None:                   # PngImageFile's open fails
            raise SyntaxError("broken PNG frame")
        if max(1, hw[1]) * max(1, hw[0]) > MAX_PIXELS:
            raise ValueError("decompression bomb")
        img = native.decode_png(png)
        if img is None:
            raise OSError("PNG frame refused")
        return (hw[1], hw[0]), img
    fp.seek(offset)
    w, h, o = _bitmap(fp, 0)
    if w <= 0 or h <= 0:
        raise SyntaxError("size below 1: not identified")
    if max(1, w) * max(1, h) > MAX_PIXELS:
        raise ValueError("decompression bomb")
    h2 = int(h / 2)
    img = _dib_pixels(data, offset, 1)
    if bpp == 32:
        got = len(data[o:o + w * h2 * 4][3::4]) if o < len(data) else 0
        if got < w * h2:
            raise ValueError("buffer is not large enough")
    else:
        wp = w + (32 - w % 32 if w % 32 else 0)
        total = int((wp * h2) / 8)
        at = offset + size - total
        if at < 0:
            raise ValueError("negative seek value")
        got = len(data[at:at + total])
        if h2 and got < (h2 - 1) * (wp // 8) + (w + 7) // 8:
            raise ValueError("not enough image data")
    return (w, h2), img


def _open_ico(fp) -> Opened:
    s = fp.read(6)
    if not ico_accepts(s):
        raise SyntaxError("not an ICO file")
    entries = []
    for _ in range(_i16le(s, 4)):
        s = fp.read(16)
        width, height = s[0] or 256, s[1] or 256
        nb_color = s[2]
        bpp = _i16le(s, 6)
        entries.append(dict(
            dim=(width, height), bpp=bpp, size=_i32le(s, 8),
            offset=_i32le(s, 12), square=width * height,
            depth=bpp or (nb_color != 0 and math.ceil(math.log(nb_color, 2)))
            or 256))
    entries.sort(key=lambda e: e["depth"])
    entries.sort(key=lambda e: e["square"], reverse=True)
    first = entries[0]
    data = fp.getvalue()
    size, img = _ico_frame(data, first["offset"], first["size"], first["bpp"])
    return Opened("ICO", "RGB", size, lambda data, by_path: img)


# -- CUR (CurImagePlugin) -----------------------------------------------------

def cur_accepts(prefix: bytes) -> bool:
    return prefix.startswith(b"\0\0\2\0")


def _open_cur(fp) -> Opened:
    s = fp.read(6)
    if not cur_accepts(s):
        raise SyntaxError("not a CUR file")
    m = b""
    for _ in range(_i16le(s, 4)):
        s = fp.read(16)
        if not m:
            m = s
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if not m:
        raise TypeError("No cursors were found")
    header = _i32le(m, 12)
    if not header:
        header = fp.tell()
    w, h, _ = _bitmap(fp, header)
    return Opened("CUR", "RGB", (w, h // 2),
                  lambda data, by_path: _dib_pixels(data, header, 1))


# -- PCX and DCX (PcxImagePlugin, DcxImagePlugin) -----------------------------

def pcx_accepts(prefix: bytes) -> bool:
    return len(prefix) >= 2 and prefix[0] == 10 and prefix[1] in (0, 2, 3, 5)


def _pcx_open(fp, fmt: str) -> Opened:
    s = fp.read(68)
    if not pcx_accepts(s):
        raise SyntaxError("not a PCX file")
    bbox = _i16le(s, 4), _i16le(s, 6), _i16le(s, 8) + 1, _i16le(s, 10) + 1
    if bbox[2] <= bbox[0] or bbox[3] <= bbox[1]:
        raise SyntaxError("bad PCX image size")
    offset = fp.tell() + 60
    version, bits, planes = s[1], s[3], s[65]
    provided_stride = _i16le(s, 66)
    palette = None
    if bits == 1 and planes == 1:
        mode = rawmode = "1"
    elif bits == 1 and planes in (2, 4):
        mode, rawmode = "P", f"P;{planes}L"
        palette = _rgb_l(s[16:64])
    elif version == 5 and bits == 8 and planes == 1:
        mode = rawmode = "L"
        fp.seek(-769, io.SEEK_END)
        s = fp.read(769)
        if len(s) == 769 and s[0] == 12:
            for i in range(256):
                if s[i * 3 + 1:i * 3 + 4] != bytes((i,)) * 3:
                    mode = rawmode = "P"
                    break
            if mode == "P":
                palette = _rgb_l(s[1:])
    elif version == 5 and bits == 8 and planes == 3:
        mode, rawmode = "RGB", "RGB;L"
    else:
        raise OSError("unknown PCX mode")
    size = bbox[2] - bbox[0], bbox[3] - bbox[1]
    stride = (size[0] * bits + 7) // 8
    if provided_stride != stride:
        stride += stride % 2

    def load(data, by_path):
        w, h = size
        nbytes = planes * stride
        ubits = _BITS[rawmode]
        if nbytes <= 0:
            raise ValueError("no line buffer")
        rows = np.zeros((h, nbytes), np.uint8)
        rc = _lib().pcx_rows(_ptr(_buf(data)), len(data), offset, w, h,
                             ubits, nbytes, _ptr(rows))
        if rc:
            raise ValueError("PCX data truncated or overrun")
        return convert.to_rgb(mode, unpack(mode, rawmode, rows, w), palette)

    return Opened(fmt, mode, size, load)


def _open_pcx(fp) -> Opened:
    return _pcx_open(fp, "PCX")


DCX_MAGIC = 0x3ADE68B1


def dcx_accepts(prefix: bytes) -> bool:
    return len(prefix) >= 4 and _i32le(prefix) == DCX_MAGIC


def _open_dcx(fp) -> Opened:
    s = fp.read(4)
    if not dcx_accepts(s):
        raise SyntaxError("not a DCX file")
    offsets = []
    for _ in range(1024):
        offset = _i32le(fp.read(4))
        if not offset:
            break
        offsets.append(offset)
    fp.seek(offsets[0])
    return _pcx_open(fp, "DCX")


# -- MSP (MspImagePlugin) -----------------------------------------------------

def msp_accepts(prefix: bytes) -> bool:
    return prefix.startswith((b"DanM", b"LinS"))


def _open_msp(fp) -> Opened:
    s = fp.read(32)
    if not msp_accepts(s):
        raise SyntaxError("not an MSP file")
    checksum = 0
    for i in range(0, 32, 2):
        checksum ^= _i16le(s, i)
    if checksum != 0:
        raise SyntaxError("bad MSP checksum")
    size = _i16le(s, 4), _i16le(s, 6)
    version1 = s.startswith(b"DanM")

    def load(data, by_path):
        w, h = size
        if version1:
            rows = raw_rows(data, 32, size, 1)
        else:
            cap = ((w + 7) // 8) * h
            stream = np.zeros(cap, np.uint8)
            n = _lib().msp_rows(_ptr(_buf(data)), len(data), w, h,
                                _ptr(stream), cap)
            if n < 0:
                raise ValueError("MSP rows cut short")
            if n < cap:
                raise ValueError("not enough image data")
            rows = stream.reshape(h, -1)
        return convert.to_rgb("1", unpack("1", "1", rows, w))

    return Opened("MSP", "1", size, load)


# -- QOI (QoiImagePlugin) -----------------------------------------------------

def qoi_accepts(prefix: bytes) -> bool:
    return prefix.startswith(b"qoif")


def _open_qoi(fp) -> Opened:
    if not qoi_accepts(fp.read(4)):
        raise SyntaxError("not a QOI file")
    size = _i32be(fp.read(4)), _i32be(fp.read(4))
    channels = fp.read(1)[0]
    mode = "RGB" if channels == 3 else "RGBA"
    fp.seek(1, io.SEEK_CUR)
    offset = fp.tell()

    def load(data, by_path):
        w, h = size
        bands = len(mode)
        out = np.zeros((h, w, bands), np.uint8)
        if _lib().qoi_decode(_ptr(_buf(data)), len(data), offset, w, h,
                             bands, _ptr(out)):
            raise ValueError("QOI data cut short")
        return np.ascontiguousarray(out[..., :3])

    return Opened("QOI", mode, size, load)


# -- SGI (SgiImagePlugin) -----------------------------------------------------

_SGI_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B",
              (2, 2, 1): "L;16B", (1, 3, 3): "RGB", (2, 3, 3): "RGB;16B",
              (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}


def sgi_accepts(prefix: bytes) -> bool:
    return len(prefix) >= 2 and _i16be(prefix) == 474


def _open_sgi(fp) -> Opened:
    s = fp.read(512)
    if not sgi_accepts(s):
        raise ValueError("Not an SGI image file")
    compression, bpc = s[2], s[3]
    dimension, xsize, ysize, zsize = (_i16be(s, 4), _i16be(s, 6),
                                      _i16be(s, 8), _i16be(s, 10))
    try:
        rawmode = _SGI_MODES[(bpc, dimension, zsize)]
    except KeyError:
        raise ValueError("Unsupported SGI image mode") from None
    size = xsize, ysize
    mode = rawmode.split(";")[0]
    bands = len(mode)

    def load(data, by_path):
        w, h = size
        if compression == 0:
            page = w * h * bpc
            if bpc == 2:
                planes = []
                for band in range(bands):
                    chunk = data[512 + band * page:512 + (band + 1) * page]
                    if len(chunk) < 2 * w * h:
                        raise ValueError("not enough image data")
                    planes.append(np.frombuffer(chunk, np.uint8).reshape(
                        h, w, 2)[::-1, :, 0])
            else:
                planes = [raw_rows(data, 512 + band * page, size, 8,
                                   ystep=-1) for band in range(bands)]
            samples = np.stack(planes, -1)
        elif compression == 1:
            out = np.zeros((h, w * bands * bpc), np.uint8)
            if _lib().sgi_rle(_ptr(_buf(data)), len(data), w, h, bands, bpc,
                              -1, _ptr(out)):
                raise ValueError("SGI RLE data refused")
            samples = out.reshape(h, w, bands, bpc)[..., 0]
        else:
            raise OSError("cannot load this image")
        return convert.to_rgb(mode, samples)

    return Opened("SGI", mode, size, load)


# -- SPIDER (SpiderImagePlugin) -----------------------------------------------

def _is_int(f) -> int:
    try:
        i = int(f)
        return 1 if f - i == 0 else 0
    except (ValueError, OverflowError):
        return 0


def _spider_header(t) -> int:
    h = (99,) + t
    for i in (1, 2, 5, 12, 13, 22, 23):
        if not _is_int(h[i]):
            return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    if labbyt != labrec * lenbyt:
        return 0
    return labbyt


def _open_spider(fp) -> Opened:
    f = fp.read(27 * 4)
    try:
        bigendian = True
        t = struct.unpack(">27f", f)
        hdrlen = _spider_header(t)
        if hdrlen == 0:
            bigendian = False
            t = struct.unpack("<27f", f)
            hdrlen = _spider_header(t)
        if hdrlen == 0:
            raise SyntaxError("not a valid Spider file")
    except struct.error as e:
        raise SyntaxError("not a valid Spider file") from e
    h = (99,) + t
    if int(h[5]) != 1:
        raise SyntaxError("not a Spider 2D image")
    size = int(h[12]), int(h[2])
    istack, imgnumber = int(h[24]), int(h[27])
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        int(h[26])
        offset = hdrlen * 2
    elif istack == 0 and imgnumber > 0:
        raise AttributeError("'SpiderImageFile' object has no attribute "
                             "'stkoffset'")
    else:
        raise SyntaxError("inconsistent stack header values")
    rawmode = "F;32BF" if bigendian else "F;32F"

    def load(data, by_path):
        rows = raw_rows(data, offset, size, 32)
        return convert.to_rgb("F", unpack("F", rawmode, rows, size[0]))

    return Opened("SPIDER", "F", size, load)


# -- TGA (TgaImagePlugin) -----------------------------------------------------

_TGA_MODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA",
              (2, 16): "BGRA;15Z", (2, 24): "BGR", (2, 32): "BGRA"}


def _open_tga(fp) -> Opened:
    s = fp.read(18)
    id_len, colormaptype, imagetype = s[0], s[1], s[2]
    depth, flags = s[16], s[17]
    size = _i16le(s, 12), _i16le(s, 14)
    if colormaptype not in (0, 1) or size[0] <= 0 or size[1] <= 0 or \
            depth not in (1, 8, 16, 24, 32):
        raise SyntaxError("not a TGA file")
    if imagetype in (3, 11):
        mode = "1" if depth == 1 else "LA" if depth == 16 else "L"
    elif imagetype in (1, 9):
        mode = "P" if colormaptype else "L"
    elif imagetype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise SyntaxError("unknown TGA mode")
    orientation = flags & 0x30
    flip = orientation in (0x10, 0x30)
    if orientation in (0x20, 0x30):
        orientation = 1
    elif orientation in (0, 0x10):
        orientation = -1
    else:
        raise SyntaxError("unknown TGA orientation")
    if id_len:
        fp.read(id_len)
    palette = None
    if colormaptype:
        start, length, mapdepth = _i16le(s, 3), _i16le(s, 5), s[7]
        if mapdepth == 16:
            raw = bytes(2 * start) + fp.read(2 * length)
            palette = ("BGRA;15Z", raw, 2)
        elif mapdepth == 24:
            raw = bytes(3 * start) + fp.read(3 * length)
            palette = ("BGR", raw, 3)
        elif mapdepth == 32:
            raw = bytes(4 * start) + fp.read(4 * length)
            palette = ("BGRA", raw, 4)
        else:
            raise SyntaxError("unknown TGA map depth")
    rawmode = _TGA_MODES.get((imagetype & 7, depth))
    offset = fp.tell()

    def load(data, by_path):
        if rawmode is None:
            raise OSError("cannot load this image")
        w, h = size
        bits = unpacker_bits(mode, rawmode)
        if imagetype & 8:
            row = (w * bits + 7) // 8
            rows = np.zeros((h, row), np.uint8)
            rc = _lib().tga_rle_rows(_ptr(_buf(data)), len(data), offset, h,
                                     depth // 8, row, _ptr(rows))
            if rc:
                raise ValueError("TGA RLE data truncated or overrun")
            if orientation < 0:
                rows = rows[::-1]
        else:
            rows = raw_rows(data, offset, size, bits, ystep=orientation)
        samples = unpack(mode, rawmode, rows, w)
        if flip:
            samples = samples[:, ::-1]
        if palette is None:
            return convert.to_rgb(mode, samples)
        # the load puts the palette on the image: a 32-bit map has no
        # unpacker, and only L, LA and P images take one; they convert
        # through it
        if palette[0] == "BGRA" or mode not in ("L", "LA", "P"):
            raise ValueError("the image takes no such palette")
        return convert.to_rgb("P", samples, _tga_palette(*palette))

    return Opened("TGA", mode, size, load)


def _tga_palette(rawmode: str, raw: bytes, k: int) -> bytes:
    """ImagePalette.raw's colours as the image's putpalette reads them
    (entries of k bytes; more than 256 refused), as RGB;L bytes."""
    n = len(raw) // k
    if n > 256:
        raise ValueError("invalid palette size")
    rows = np.frombuffer(raw[:n * k], np.uint8).reshape(1, n * k)
    return np.ascontiguousarray(unpack("RGBA", rawmode, rows, n)[0, :, :3].T
                                ).tobytes()


# -- XBM (XbmImagePlugin) -----------------------------------------------------

_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)


def xbm_accepts(prefix: bytes) -> bool:
    return prefix.lstrip().startswith(b"#define")


def _open_xbm(fp) -> Opened:
    m = _XBM_HEAD.match(fp.read(512))
    if not m:
        raise SyntaxError("not a XBM file")
    size = int(m.group("width")), int(m.group("height"))
    offset = m.end()

    def load(data, by_path):
        w, h = size
        rows = np.zeros((h, (w + 7) // 8), np.uint8)
        if _lib().xbm_rows(_ptr(_buf(data)), len(data), offset, w, h,
                           _ptr(rows)):
            raise ValueError("XBM data cut short")
        return convert.to_rgb("1", unpack("1", "1;R", rows, w))

    return Opened("XBM", "1", size, load)


# -- IM (ImImagePlugin) -------------------------------------------------------

_IM_TAGS = ("Comment", "Date", "Digitalization equipment",
            "File size (no of images)", "Lut", "Name", "Scale (x,y)",
            "Image size (x*y)", "Image type")
IM_OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"),
    "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
    "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
    "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
    "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
    "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
    "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
    "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    IM_OPEN[f"L {_i} image"] = ("F", f"F;{_i}")
    IM_OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    IM_OPEN[f"L {_i} image"] = (f"I;{_i}", f"I;{_i}")
    IM_OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
for _i in ("32S",):
    IM_OPEN[f"L {_i} image"] = ("I", f"I;{_i}")
    IM_OPEN[f"L*{_i} image"] = ("I", f"I;{_i}")
for _j in range(2, 33):
    IM_OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")

_IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def _open_im(fp) -> Opened:
    if b"\n" not in fp.read(100):
        raise SyntaxError("not an IM file")
    fp.seek(0)
    n = 0
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    rawmode = "L"
    while True:
        s = fp.read(1)
        if s == b"\r":
            continue
        if not s or s == b"\0" or s == b"\x1a":
            break
        s = s + fp.readline()
        if len(s) > 100:
            raise SyntaxError("not an IM file")
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = _IM_SPLIT.match(s)
        if not m:
            raise SyntaxError("Syntax error in IM header")
        k, v = m.group(1, 2)
        k = k.decode("latin-1", "replace")
        v = v.decode("latin-1", "replace")
        if k in ("File size (no of images)", "Scale (x,y)",
                 "Image size (x*y)"):
            v = v.replace("*", ",")
            v = tuple(map(_number, v.split(",")))
            if len(v) == 1:
                v = v[0]
        elif k == "Image type" and v in IM_OPEN:
            v, rawmode = IM_OPEN[v]
        if k != "Comment":
            info[k] = v
        if k in _IM_TAGS:
            n += 1
    if not n:
        raise SyntaxError("Not an IM file")
    size = info["Image size (x*y)"]
    mode = info["Image type"]
    while s and not s.startswith(b"\x1a"):
        s = fp.read(1)
    if not s:
        raise SyntaxError("File truncated")
    palette = None
    if "Lut" in info:
        lut = fp.read(768)
        greyscale = linear = True
        for i in range(256):
            if lut[i] == lut[i + 256] == lut[i + 512]:
                if lut[i] != i:
                    linear = False
            else:
                greyscale = False
        if mode in ("L", "LA", "P", "PA"):
            if not greyscale:
                if mode in ("L", "P"):
                    mode = rawmode = "P"
                elif mode in ("LA", "PA"):
                    mode, rawmode = "PA", "PA;L"
                palette = lut                  # RGB;L
    offset = fp.tell()

    def load(data, by_path):
        w, h = _whole(size)
        if rawmode.startswith("F;"):
            try:
                bits = int(rawmode[2:])
            except ValueError:
                bits = None
            if bits is not None and bits not in (8, 16, 32):
                if mode != "F":
                    raise ValueError("the bit decoder needs an F image")
                out = np.zeros((h, w), np.float32)
                rc = _lib().bit_decode(_ptr(_buf(data)), len(data), offset,
                                       w, h, bits,
                                       out.ctypes.data_as(
                                           ctypes.POINTER(ctypes.c_float)))
                if rc:
                    raise ValueError("IM bit data refused")
                return convert.to_rgb("F", out)
        if rawmode in ("RGB;T", "RYB;T"):
            # three tiles, the G, R and B bands' planes in that order
            if mode not in ("RGB", "RGBA", "RGBX"):
                raise ValueError("unknown raw mode for given image mode")
            g, r, b = (raw_rows(data, offset + k * w * h, (w, h), 8,
                                ystep=-1)[:, :w] for k in range(3))
            return np.stack([r, g, b], -1)
        if mode not in _UNPACKERS:
            raise ValueError(f"cannot load an IM image of mode {mode}")
        bits = unpacker_bits(mode, rawmode)
        rows = raw_rows(data, offset, (w, h), bits, ystep=-1)
        samples = unpack(mode, rawmode, rows, w)
        return convert.to_rgb(mode, samples, palette)

    return Opened("IM", mode, size, load)


OPENERS: Dict[str, Callable] = {
    "DIB": _open_dib, "CUR": _open_cur, "PCX": _open_pcx, "DCX": _open_dcx,
    "ICO": _open_ico, "IM": _open_im, "MSP": _open_msp, "QOI": _open_qoi,
    "SGI": _open_sgi, "SPIDER": _open_spider, "TGA": _open_tga,
    "XBM": _open_xbm,
}
