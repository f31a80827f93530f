"""JPEG 2000 (a J2K codestream or a JP2 file) as Pillow 12.1.0's
``Jpeg2KImagePlugin`` reads it over OpenJPEG 2.5.4, then
``convert("RGB")``.

The JAX package hands every image that is not a JPEG to Pillow. This
module is the port's copy of what Pillow does with a file whose first
bytes its JPEG 2000 plugin accepts (``FF 4F FF 51``, or the JP2
signature box):

- the open (``open_j2k``): Pillow's ``BoxReader``, ``_parse_codestream``
  (the size and mode from SIZ), ``_parse_jp2_header`` (the size and mode
  from ``ihdr``, CMYK from ``colr``, P or PA from a ``pclr`` whose widest
  entry has at most 8 bits, its palette built as ``ImagePalette.getcolor``
  builds it), ``_parse_comment``, and the pixel limit of Pillow's open;
- the load: the port's OpenJPEG decoder with Pillow's ``Jpeg2KDecode.c``
  around it (csrc/j2k_decode.cc: the codestream and its tiles, and
  Pillow's unpackers into the image of the open's mode and size);
- ``convert("RGB")`` of that image (data/convert.py, and the palette's
  colours for P and PA).

Where the plugin raises one of the errors Pillow's open takes as "not
this format", ``NotJpeg2k`` is raised (no other plugin of Pillow's opens
such a file: tests/test_torch_jpeg2k.py); every other refusal raises
ValueError, as Pillow's open or load fails. ``route`` says, from the
markers alone, whether the port decodes the file: HTJ2K code-blocks
(Part 15) and the Part 2 multi-component transform are left to others.
"""

from __future__ import annotations

import io
import os
import struct
from typing import NamedTuple, Optional, Tuple

import numpy as np

from yolov5m_tpu_torch.data import convert

J2K_PREFIX = b"\xff\x4f\xff\x51"
JP2_PREFIX = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
PREFIXES = (J2K_PREFIX, JP2_PREFIX)
MAX_PIXELS = 2 * 89478485          # twice PIL.Image.MAX_IMAGE_PIXELS
# the modes as csrc/j2k_decode.cc numbers them, and Pillow's bytes a pixel
MODE_CODES = {"L": 0, "I;16": 1, "LA": 2, "RGB": 3, "RGBA": 4, "CMYK": 5,
              "P": 6, "PA": 7}
PIXEL_BYTES = {"L": 1, "P": 1, "I;16": 2}
# what Pillow's open takes for "not this plugin's file"
_PASSED_ON = (SyntaxError, IndexError, TypeError, KeyError, EOFError,
              struct.error)


class NotJpeg2k(Exception):
    """Pillow's JPEG 2000 plugin raises an error its open takes for "not
    this format", so Pillow goes on to its other plugins."""


class Header(NamedTuple):
    codec: str                      # "j2k" or "jp2"
    size: Tuple[int, int]           # (width, height)
    mode: str
    palette: Optional[bytes]        # ImagePalette's bytes, for P and PA
    palette_mode: Optional[str]     # "RGB" or "RGBA"


def accepts(prefix: bytes) -> bool:
    """Pillow's _accept."""
    return bytes(prefix).startswith(PREFIXES)


class _BoxReader:
    """Pillow's BoxReader, as it is."""

    def __init__(self, fp, length: int = -1) -> None:
        self.fp = fp
        self.has_length = length >= 0
        self.length = length
        self.remaining_in_box = -1

    def _can_read(self, num_bytes: int) -> bool:
        if self.has_length and self.fp.tell() + num_bytes > self.length:
            return False
        if self.remaining_in_box >= 0:
            return num_bytes <= self.remaining_in_box
        return True

    def _read_bytes(self, num_bytes: int) -> bytes:
        if not self._can_read(num_bytes):
            raise SyntaxError("Not enough data in header")
        data = self.fp.read(num_bytes)
        if len(data) < num_bytes:
            raise OSError(f"Expected to read {num_bytes} bytes but only got "
                          f"{len(data)}.")
        if self.remaining_in_box > 0:
            self.remaining_in_box -= num_bytes
        return data

    def read_fields(self, field_format: str) -> tuple:
        size = struct.calcsize(field_format)
        return struct.unpack(field_format, self._read_bytes(size))

    def read_boxes(self) -> "_BoxReader":
        size = self.remaining_in_box
        data = self._read_bytes(size)
        return _BoxReader(io.BytesIO(data), size)

    def has_next_box(self) -> bool:
        if self.has_length:
            return self.fp.tell() + self.remaining_in_box < self.length
        return True

    def next_box_type(self) -> bytes:
        if self.remaining_in_box > 0:
            self.fp.seek(self.remaining_in_box, os.SEEK_CUR)
        self.remaining_in_box = -1
        lbox, tbox = self.read_fields(">I4s")
        if lbox == 1:
            lbox = self.read_fields(">Q")[0]
            hlen = 16
        else:
            hlen = 8
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise SyntaxError("Invalid header length")
        self.remaining_in_box = lbox - hlen
        return tbox


def _i16be(c: bytes) -> int:
    return struct.unpack_from(">H", c)[0]


def _parse_codestream(fp) -> Tuple[Tuple[int, int], str]:
    hdr = fp.read(2)
    lsiz = _i16be(hdr)
    siz = hdr + fp.read(lsiz - 2)
    _, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _, csiz = struct.unpack_from(
        ">HHIIIIIIIIH", siz)
    size = (xsiz - xosiz, ysiz - yosiz)
    if csiz == 1:
        ssiz = struct.unpack_from(">B", siz, 38)
        mode = "I;16" if (ssiz[0] & 0x7F) + 1 > 8 else "L"
    elif csiz == 2:
        mode = "LA"
    elif csiz == 3:
        mode = "RGB"
    elif csiz == 4:
        mode = "RGBA"
    else:
        raise SyntaxError("unable to determine J2K image mode")
    return size, mode


class _Palette:
    """ImagePalette.getcolor's bookkeeping, for a new palette of mode
    "RGB" or "RGBA" (a colour seen before keeps its index; a colour of
    another length than the mode's is stored as it comes)."""

    def __init__(self, mode: str) -> None:
        self.mode = mode
        self.palette = bytearray()
        self.colors: dict = {}

    def getcolor(self, color: tuple) -> int:
        if self.mode == "RGB":
            if len(color) == 4:
                if color[3] != 255:
                    raise ValueError("cannot add non-opaque RGBA color to "
                                     "RGB palette")
                color = color[:3]
        elif self.mode == "RGBA":
            if len(color) == 3:
                color += (255,)
        if color in self.colors:
            return self.colors[color]
        mode_len = len(self.mode)
        index = len(self.palette) // mode_len
        if index >= 256:
            raise ValueError("cannot allocate more than 256 colors")
        self.colors[color] = index
        if index * mode_len < len(self.palette):
            self.palette = (self.palette[:index * mode_len] + bytes(color) +
                            self.palette[index * mode_len + mode_len:])
        else:
            self.palette += bytes(color)
        return index


def _parse_jp2_header(fp) -> tuple:
    reader = _BoxReader(fp)
    header = None
    while reader.has_next_box():
        tbox = reader.next_box_type()
        if tbox == b"jp2h":
            header = reader.read_boxes()
            break
        elif tbox == b"ftyp":
            reader.read_fields(">4s")
    if header is None:           # Pillow's assert
        raise AssertionError("no jp2h box")
    size = mode = nc = None
    palette = None
    while header.has_next_box():
        tbox = header.next_box_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.read_fields(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            elif nc == 1:
                mode = "L"
            elif nc == 2:
                mode = "LA"
            elif nc == 3:
                mode = "RGB"
            elif nc == 4:
                mode = "RGBA"
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.read_fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.read_fields(">HB")
            max_bitdepth = 0
            for bitdepth in header.read_fields(">" + "B" * npc):
                if bitdepth > max_bitdepth:
                    max_bitdepth = bitdepth
            if max_bitdepth <= 8:
                palette = _Palette("RGBA" if npc == 4 else "RGB")
                for _ in range(ne):
                    palette.getcolor(tuple(header.read_fields(
                        ">" + "B" * npc)))
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.read_boxes()
            while res.has_next_box():
                if res.next_box_type() == b"resc":
                    res.read_fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise SyntaxError("Malformed JP2 header")
    return size, mode, palette


def _parse_comment(fp) -> None:
    while True:
        marker = fp.read(2)
        if not marker:
            break
        typ = marker[1]
        if typ in (0x90, 0xD9):
            break
        hdr = fp.read(2)
        length = _i16be(hdr)
        if typ == 0x64:
            fp.read(length - 2)
            break
        fp.seek(length - 2, os.SEEK_CUR)


def _open(fp) -> Header:
    palette = None
    sig = fp.read(4)
    if sig == J2K_PREFIX:
        codec = "j2k"
        size, mode = _parse_codestream(fp)
        _parse_comment(fp)
    else:
        sig = sig + fp.read(8)
        if sig != JP2_PREFIX:
            raise SyntaxError("not a JPEG 2000 file")
        codec = "jp2"
        size, mode, palette = _parse_jp2_header(fp)
        if fp.read(12).endswith(b"jp2c\xff\x4f\xff\x51"):
            length = _i16be(fp.read(2))
            fp.seek(length - 2, os.SEEK_CUR)
            _parse_comment(fp)
    return Header(codec, size, mode,
                  None if palette is None else bytes(palette.palette),
                  None if palette is None else palette.mode)


def open_j2k(data) -> Header:
    """Pillow's open of the file's bytes: NotJpeg2k where the plugin passes
    the file on (Pillow's ImageFile also passes on a size below 1 and an
    unknown mode), ValueError where the open fails (the pixel limit among
    it)."""
    try:
        header = _open(io.BytesIO(bytes(data)))
    except _PASSED_ON as e:
        raise NotJpeg2k(str(e)) from None
    except (OSError, ValueError, AssertionError) as e:
        raise ValueError(f"JPEG 2000 open: {e}") from None
    w, h = header.size
    if not header.mode or w <= 0 or h <= 0:
        raise NotJpeg2k("no mode, or a width or height below 1")
    if max(1, w) * max(1, h) > MAX_PIXELS:
        raise ValueError("JPEG 2000 open: past Pillow's pixel limit")
    return header


def size(data) -> Tuple[int, int]:
    """(h, w) as Pillow's open reads it."""
    w, h = open_j2k(data).size
    return h, w


# the markers this slice leaves to others (ROADMAP.md items 44 and 45):
# code-block style 0x40 (HTJ2K) in COD or COC, and Part 2's MCT, MCC, MCO
_MCT_MARKERS = (0xFF74, 0xFF75, 0xFF77)


def _codestream_at(data: bytes, header: Header) -> int:
    """Where the codestream starts: after the JP2 boxes before jp2c (-1
    where there is none)."""
    if header.codec == "j2k":
        return 0
    pos = 0
    while pos + 8 <= len(data):
        lbox, tbox = struct.unpack_from(">I4s", data, pos)
        hlen = 8
        if lbox == 1:
            if pos + 16 > len(data):
                return -1
            lbox = struct.unpack_from(">Q", data, pos + 8)[0]
            hlen = 16
        if tbox == b"jp2c":
            return pos + hlen
        if lbox < hlen:
            return -1
        pos += lbox
    return -1


def _left_to_others(marker: int, seg: bytes, ncomp: int) -> bool:
    """Whether a marker segment names a feature left to others: an MCT,
    MCC or MCO marker, or a COD or COC with code-block style bit 0x40."""
    if marker in _MCT_MARKERS:
        return True
    if marker == 0xFF52:
        return len(seg) >= 9 and bool(seg[8] & 0x40)
    if marker == 0xFF53:
        room = 1 if ncomp <= 256 else 2
        return len(seg) >= room + 5 and bool(seg[room + 4] & 0x40)
    return False


def route(header: Header, data) -> Optional[str]:
    """"decode" where the port decodes the file, None where its markers
    name a feature left to others (``_left_to_others``) in the main header
    or in a tile-part header. The headers are walked by their lengths and
    the tile-parts by Psot; a walk that runs off the file stops there."""
    data = bytes(data)
    pos = _codestream_at(data, header)
    if pos < 0 or data[pos:pos + 2] != b"\xff\x4f":
        return "decode"
    pos += 2
    ncomp = 0
    while pos + 4 <= len(data):
        marker, length = struct.unpack_from(">HH", data, pos)
        if marker < 0xFF00 or length < 2:
            break
        seg = data[pos + 4:pos + 2 + length]
        if marker == 0xFF51 and len(seg) >= 36:
            ncomp = struct.unpack_from(">H", seg, 34)[0]
        if _left_to_others(marker, seg, ncomp):
            return None
        if marker == 0xFF90 and len(seg) >= 8:
            psot = struct.unpack_from(">I", seg, 2)[0]
            # the tile-part's header, up to its SOD
            tp = pos + 2 + length
            while tp + 4 <= len(data):
                m, ln = struct.unpack_from(">HH", data, tp)
                if m == 0xFF93 or m < 0xFF00 or ln < 2:
                    break
                if _left_to_others(m, data[tp + 4:tp + 2 + ln], ncomp):
                    return None
                tp += 2 + ln
            if psot == 0:
                break
            pos += psot
            continue
        pos += 2 + length
    return "decode"


def _palette_rgbl(palette: bytes, mode: str) -> bytes:
    """The palette's whole entries as Pillow's putpalette takes them (3 or
    4 bytes each, the mode's), their colours as RGB;L bytes for
    data/convert.py (which gives black past them, as Pillow's conversion
    gives an index past the palette)."""
    step = len(mode)
    n = min(len(palette) // step, 256)
    entries = np.frombuffer(palette[:n * step], np.uint8).reshape(n, step)
    return entries[:, :3].T.tobytes()


def decode(data, header: Optional[Header] = None) -> np.ndarray:
    """(h, w, 3) uint8 as Pillow's ``Image.open(...).convert("RGB")``
    gives it; ValueError where Pillow's open or load fails (NotJpeg2k
    where the plugin passes the file on)."""
    from yolov5m_tpu_torch.data import native

    data = bytes(data)
    if header is None:
        header = open_j2k(data)
    w, h = header.size
    mode = header.mode
    out = np.zeros((h, w * PIXEL_BYTES.get(mode, 4)), np.uint8)
    lib = native.decode_lib()
    buf = np.frombuffer(data, np.uint8)
    if lib.j2k_decode(native._as_u8p(buf), len(data),
                      0 if header.codec == "j2k" else 2, MODE_CODES[mode],
                      w, h, native._as_u8p(out)):
        raise ValueError("JPEG 2000: the decode fails where Pillow's does")
    if mode in ("L", "P"):
        samples = out
    elif mode == "I;16":
        samples = out.view("<u2")
    else:
        samples = out.reshape(h, w, 4)
    if mode in ("P", "PA"):
        return convert.to_rgb(mode, samples, _palette_rgbl(
            header.palette, header.palette_mode))
    if mode == "I;16":
        return convert.to_rgb("I;16", samples.astype(np.int32))
    return convert.to_rgb(mode, samples)
