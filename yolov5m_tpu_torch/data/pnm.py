"""PNM (PBM, PGM, PPM, ``Pf`` and Pillow's own extensions) as Pillow
12.1.0's ``PpmImagePlugin`` reads it, then ``convert("RGB")``.

The JAX package hands every image that is not a JPEG to Pillow (the
server's and the loader's ``_decode_image``, detect ``--img``'s
``Image.open``, the dataset's ``_read_image_size``). This module is the
port's copy of what Pillow does with a file whose first two bytes its PPM
plugin accepts (``P`` and one of ``0123456fy``), in Python and numpy:

- the magic number is read up to 6 bytes or the first whitespace byte,
  and must be one of ``MODES``; otherwise the plugin raises SyntaxError
  and Pillow goes on to its other plugins (``NotPnm`` here);
- each header token skips leading whitespace and ``#`` comments (to CR,
  LF or the end; the same token goes on after one), is at most 10 bytes,
  and is read with Python's ``int`` (``float`` for ``Pf``'s scale); a
  width or height of 0 or less is a SyntaxError, and more than twice
  Pillow's ``MAX_IMAGE_PIXELS`` is refused;
- the pixel data starts just after the byte that ended the last token;
- P1-P3 go through Pillow's ``ppm_plain`` decoder (1 MiB blocks, comments
  removed block by block, tokens split across blocks carried over), P4,
  ``Pf`` and files at maxval 255 (P5 also at 65535) through its ``raw``
  decoder, every other binary file through its ``ppm`` decoder, which
  scales each sample to the mode's range and clips;
- a grey file above maxval 255 is mode ``I``; ``convert("RGB")``
  (data/convert.py) clips it to 0..255, truncates ``F`` toward zero after
  clipping (NaN gives 0), maps CMYK as Pillow's ``cmyk2rgb``, drops
  RGBA's alpha and gives 0 for a ``PyP`` file, which has no palette.

Every refusal (a short file, a bad token, a value above maxval) raises
ValueError, as Pillow refuses the file.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np

from yolov5m_tpu_torch.data import convert

WHITESPACE = b" \t\n\x0b\x0c\r"    # Pillow's b_whitespace, bytes.split()'s

# magic number -> Pillow's mode
MODES = {
    b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
    b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
    b"PyRGBA": "RGBA", b"PyCMYK": "CMYK",
}
BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "F": 1, "RGB": 3, "RGBA": 4,
         "CMYK": 4}
MAX_TOKEN = 10                     # longer header and data tokens refused
SAFEBLOCK = 1024 * 1024            # ImageFile.SAFEBLOCK: ppm_plain's reads
MAX_PIXELS = 2 * 89478485          # twice PIL.Image.MAX_IMAGE_PIXELS

class NotPnm(Exception):
    """Pillow's PPM plugin raises SyntaxError on the file (a magic number
    it does not know, a width or height below 1), so Pillow's open goes
    on to its other plugins."""


class Header(NamedTuple):
    mode: str          # Pillow's mode after open ("L" above 255 is "I")
    width: int
    height: int
    decoder: str       # "raw", "ppm" or "ppm_plain"
    rawmode: str       # the raw decoder's: "1;I", "I;16B", "F;32F", ...
    maxval: int        # 0 for P1, P4 and Pf
    offset: int        # the first byte of the pixel data

    @property
    def size(self) -> Tuple[int, int]:
        """(w, h), as Pillow's ``im.size``."""
        return self.width, self.height


def accepts(prefix: bytes) -> bool:
    """Pillow's PPM ``_accept``: ``P`` and one of ``0123456fy``."""
    return len(prefix) >= 2 and prefix[:1] == b"P" and \
        prefix[1] in b"0123456fy"


def _read_magic(data: bytes) -> Tuple[bytes, int]:
    """Up to 6 bytes, stopping at (and consuming) a whitespace byte."""
    end = min(len(data), 6)
    for i in range(end):
        if data[i] in WHITESPACE:
            return data[:i], i + 1
    return data[:end], end


def _line_end(data: bytes, pos: int) -> int:
    """Just past the first CR or LF from pos, or the end of the data."""
    ends = [i for i in (data.find(b"\n", pos), data.find(b"\r", pos))
            if i >= 0]
    return min(ends) + 1 if ends else len(data)


def _read_token(data: bytes, pos: int,
                complete: bool) -> Tuple[bytes, int]:
    """Pillow's ``_read_token`` from pos: (token, position after the byte
    that ended it). Raises ValueError on no token or one over 10 bytes,
    and where data is a prefix of the file (not complete) on reaching its
    end, where the file may go on."""
    n = len(data)
    token = bytearray()
    while len(token) <= MAX_TOKEN:
        if pos >= n:
            if not complete:
                raise ValueError("the header runs past the bytes read")
            break
        c = data[pos]
        pos += 1
        if c in WHITESPACE:
            if not token:
                continue
            break
        if c == 0x23:                              # '#'
            pos = _line_end(data, pos)
            continue
        token.append(c)
    if not token:
        raise ValueError("Reached EOF while reading header")
    if len(token) > MAX_TOKEN:
        raise ValueError("Token too long in file header")
    return bytes(token), pos


def read_header(data: bytes, complete: bool = True) -> Header:
    """What Pillow's ``Image.open`` reads of a PNM file, from its bytes or,
    not complete, a prefix of them. Raises NotPnm where the plugin raises
    SyntaxError, ValueError where the open fails (a bad token, maxval or
    scale, the decompression-bomb limit) or the prefix ends too soon."""
    data = bytes(data)
    magic, pos = _read_magic(data)
    if magic not in MODES:
        raise NotPnm(f"not a PPM file: {magic!r}")
    mode = MODES[magic]
    tok, pos = _read_token(data, pos, complete)
    width = int(tok)
    tok, pos = _read_token(data, pos, complete)
    height = int(tok)
    decoder = "ppm_plain" if magic in (b"P1", b"P2", b"P3") else "raw"
    maxval = 0
    if mode == "1":
        rawmode = "1;I"
    elif mode == "F":
        tok, pos = _read_token(data, pos, complete)
        scale = float(tok)
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError("scale must be finite and non-zero")
        rawmode = "F;32F" if scale < 0 else "F;32BF"
    else:
        tok, pos = _read_token(data, pos, complete)
        maxval = int(tok)
        if not 0 < maxval < 65536:
            raise ValueError("maxval must be greater than 0 and less than "
                             "65536")
        rawmode = mode
        if decoder != "ppm_plain":
            if maxval == 65535 and mode == "L":
                rawmode = "I;16B"
            elif maxval != 255:
                decoder = "ppm"
        if maxval > 255 and mode == "L":
            mode = "I"
    if width <= 0 or height <= 0:
        raise NotPnm(f"a size of {width}x{height}")
    if width * height > MAX_PIXELS:
        raise ValueError(f"{width * height} pixels is past the "
                         f"decompression-bomb limit")
    return Header(mode, width, height, decoder, rawmode, maxval, pos)


def size(data: bytes, complete: bool = True) -> Tuple[int, int]:
    """(h, w) as Pillow's open reads it, without the pixel data, from the
    file's bytes or a prefix of them (read_header)."""
    header = read_header(data, complete)
    return header.height, header.width


# -- decoders -----------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _scale_lut(maxval: int, out_max: int, count: int) -> np.ndarray:
    """Pillow's ``min(out_max, round(value / maxval * out_max))`` for every
    value below count, in its own float arithmetic; uint8 where out_max is
    255."""
    return np.array([min(out_max, round(v / maxval * out_max))
                     for v in range(count)],
                    np.uint8 if out_max == 255 else np.int32)


def _raw(data: bytes, h: Header) -> np.ndarray:
    """Pillow's raw decoder: the samples of the mode, (h, w, bands)."""
    w, ht = h.width, h.height
    bands = BANDS[h.mode]
    if h.rawmode == "1;I":
        stride = (w + 7) // 8
    elif h.rawmode == "I;16B":
        stride = w * 2
    elif h.mode == "F":
        stride = w * 4
    else:
        stride = w * bands
    if len(data) - h.offset < stride * ht:
        raise ValueError("image file is truncated")
    if h.rawmode == "1;I":
        rows = np.frombuffer(data, np.uint8, stride * ht, h.offset)
        bits = np.unpackbits(rows.reshape(ht, stride), axis=1)[:, :w]
        return ((1 - bits) * 255).astype(np.uint8)[..., None]
    if h.rawmode == "I;16B":
        return np.frombuffer(data, ">u2", w * ht, h.offset).reshape(
            ht, w, 1)
    if h.mode == "F":
        dtype = "<f4" if h.rawmode == "F;32F" else ">f4"
        return np.frombuffer(data, dtype, w * ht, h.offset).reshape(
            ht, w, 1)[::-1]                        # rows bottom to top
    return np.frombuffer(data, np.uint8, stride * ht, h.offset).reshape(
        ht, w, bands)


def _ppm(data: bytes, h: Header) -> np.ndarray:
    """Pillow's ``ppm`` decoder: 1 byte a sample below maxval 256, else 2
    big-endian; each scaled to the mode's range and clipped."""
    bands = BANDS[h.mode]
    count = h.width * h.height * bands
    wide = h.maxval >= 256
    if len(data) - h.offset < count * (2 if wide else 1):
        raise ValueError("not enough image data")
    raw = np.frombuffer(data, ">u2" if wide else np.uint8, count, h.offset)
    out_max = 65535 if h.mode == "I" else 255
    lut = _scale_lut(h.maxval, out_max, 65536 if wide else 256)
    return lut[raw].reshape(h.height, h.width, bands)


class _Blocks:
    """The plain decoder's reads of the file: SAFEBLOCK bytes at a time
    from the pixel data on, and its comment removal (``_ignore_comments``,
    whose state carries from block to block)."""

    def __init__(self, data: bytes, offset: int):
        self.data, self.pos = data, offset
        self.comment_spans = False

    def read(self) -> bytes:
        block = self.data[self.pos:self.pos + SAFEBLOCK]
        self.pos += len(block)
        return block

    @staticmethod
    def _comment_end(block: bytes, start: int = 0) -> int:
        a, b = block.find(b"\n", start), block.find(b"\r", start)
        # Pillow's rule: the later of the two when one is at index 0
        return min(a, b) if a * b > 0 else max(a, b)

    def strip_comments(self, block: bytes) -> bytes:
        if self.comment_spans:
            while block:
                end = self._comment_end(block)
                if end != -1:
                    block = block[end + 1:]
                    break
                block = self.read()
        self.comment_spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                break
            end = self._comment_end(block, start)
            if end != -1:
                block = block[:start] + block[end + 1:]
            else:
                block = block[:start]
                self.comment_spans = True
                break
        return block


def _bitonal(data: bytes, h: Header) -> np.ndarray:
    """P1: every byte but whitespace is a pixel, ``0`` white and ``1``
    black; every such byte of a block read is checked."""
    total = h.width * h.height
    blocks, parts, have = _Blocks(data, h.offset), [], 0
    while have != total:
        block = blocks.read()
        if not block:
            break
        pixels = blocks.strip_comments(block).translate(None, WHITESPACE)
        if pixels.translate(None, b"01"):
            raise ValueError("Invalid token for this mode")
        pixels = pixels[:total - have]
        parts.append(pixels)
        have += len(pixels)
    if have != total:
        raise ValueError("not enough image data")
    codes = np.frombuffer(b"".join(parts), np.uint8)
    return np.where(codes == ord("1"), 0, 255).astype(np.uint8).reshape(
        h.height, h.width, 1)


def _token_values(body: bytes, need: int, maxval: int) -> np.ndarray:
    """The first ``need`` (or fewer) whitespace-separated tokens of body as
    Pillow's loop reads them: each at most 10 bytes, ``int`` of it, neither
    negative nor above maxval. The C scan (csrc/pnm_decode.cc) reads tokens
    of digits; a block with any other token is read with Python's int."""
    # native imports this module
    from yolov5m_tpu_torch.data.native import _as_u8p, decode_lib

    buf = np.frombuffer(body, np.uint8)
    out = np.empty(min(need, (buf.size + 1) // 2), np.int32)
    count = decode_lib().pnm_plain_tokens(
        _as_u8p(buf), buf.size, need, maxval,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if count == -3:
        values = []
        for token in body.split()[:need]:
            if len(token) > MAX_TOKEN:
                raise ValueError("Token too long found in data")
            values.append(int(token))
        if min(values) < 0 or max(values) > maxval:
            raise ValueError("Channel value out of range for this mode")
        return np.array(values, np.int32)
    if count < 0:
        raise ValueError("Token too long found in data" if count == -1
                         else "Channel value too large for this mode")
    return out[:count]


def _plain(data: bytes, h: Header) -> np.ndarray:
    """Pillow's ``ppm_plain`` decoder for P2 and P3 (``_decode_blocks``)."""
    bands = BANDS[h.mode]
    total = h.width * h.height * bands
    out_max = 65535 if h.mode == "I" else 255
    blocks, parts, have, half = _Blocks(data, h.offset), [], 0, b""
    while have != total:
        block = blocks.read()
        if not block:
            if not half:
                break
            block = b" "                       # flush the half token
        block = blocks.strip_comments(block)
        if half:
            block, half = half + block, b""
        if block and block[-1] not in WHITESPACE:
            # the block may split its last token: keep it for the next
            cut = max(block.rfind(bytes([c])) for c in WHITESPACE) + 1
            block, half = block[:cut], block[cut:]
            if len(half) > MAX_TOKEN:
                raise ValueError("Token too long found in data")
        values = _token_values(block, total - have, h.maxval)
        parts.append(values)
        have += values.size
    if have != total:
        raise ValueError("not enough image data")
    lut = _scale_lut(h.maxval, out_max, h.maxval + 1)
    return lut[np.concatenate(parts)].reshape(h.height, h.width, bands)


def decode(data: bytes, header: Optional[Header] = None) -> np.ndarray:
    """(h, w, 3) uint8: Pillow's ``Image.open(...).convert("RGB")`` of a
    PNM file (header: read_header's, where read already). Raises NotPnm
    where Pillow's PPM plugin passes the file on to its other plugins,
    ValueError where Pillow refuses it."""
    data = bytes(data)
    if header is None:
        header = read_header(data)
    if header.decoder == "ppm_plain":
        samples = (_bitonal if header.mode == "1" else _plain)(data, header)
    elif header.decoder == "ppm":
        samples = _ppm(data, header)
    else:
        samples = _raw(data, header)
    return convert.to_rgb(header.mode, samples)
