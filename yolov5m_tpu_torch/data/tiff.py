"""TIFF as Pillow 12.1.0's ``TiffImagePlugin`` reads it (over libtiff 4.7.1
where the file is compressed), then ``convert("RGB")`` and
``exif_transpose``.

The JAX package hands every TIFF to Pillow (the server's and the loader's
``_decode_image``, ``load_image_rgb``, detect ``--img``'s ``Image.open``,
the dataset's ``_read_image_size``). This module is the port's copy of
what Pillow does with a file whose first four bytes are one of its six
``PREFIXES``, for ``Compression`` 1 (uncompressed), 5 (LZW), 8 and 32946
(deflate), 32773 (PackBits), 7 (JPEG, 8-bit and 12-bit), 6 (old-style
JPEG), 50000 (ZSTD, its legacy v0.5-v0.7 frames too) and 34925 (LZMA),
every photometric interpretation Pillow opens, CIELab (``LAB``) included:

- the open (``open_tiff``): the header, IFD0 as ``ImageFileDirectory_v2``
  reads it (tag types, values inline or at an offset, tags past the end of
  the file skipped, a short directory read as far as it goes), and
  ``_setup``: ``COMPRESSION_INFO``, the photometric and sample-format
  defaults, the ``BitsPerSample`` trimming and extension, ``OPEN_INFO``
  (copied whole), the raw route's tile list, the palette, the size
  swapped for Orientation 5-8 and the decompression-bomb limit. Where
  Pillow's open raises SyntaxError (or an error its ``ImageFile`` turns
  into one) the plugin passes the file on to Pillow's other plugins:
  ``NotTiff`` here;
- uncompressed files load on Pillow's ``raw`` route (``ImageFile.load``:
  its tile sort, the memory map of a single-strip file opened by path,
  "image file is truncated"), unpacked in numpy as Pillow's unpackers do;
- compressed files load as Pillow's ``TiffDecode.c`` drives libtiff:
  libtiff's own read of the directory (``libtiff_dir``: the YCbCr tags,
  JPEGTables, the subsampling JPEGFixupTags reads from the first strip;
  the old-style JPEG codec's tags and directory fix-ups, and the
  subsampling OJPEGSubsamplingCorrect reads from the first SOF), then
  strips or tiles, contiguous or planar, decoded by the port's C
  (csrc/tiff_decode.cc: PackBits, LZW in both code orders, the
  predictors; csrc/jpeg_decode.cc: libtiff's JPEG codec, YCbCr in one
  plane converted to RGB as JPEGCOLORMODE_RGB has libjpeg convert it,
  12-bit grey through jpeg12 with each pair of samples packed in three
  bytes; libtiff's old-style JPEG codec, tif_ojpeg.c, its sessions read
  by read, ``_decode_ojpeg``;
  csrc/zstd_decode.cc and csrc/xz_decode.cc: ZSTDDecode over libzstd
  1.5.7, with its legacy decoders of v0.5-v0.7 frames, and LZMADecode
  over liblzma 5.8.2, a refused chunk zeroed past the library's output
  position as libtiff zeroes it) or inflated by
  Python's zlib; every other YCbCr file through
  ``TIFFRGBAImage`` (``_load_rgba``: libtiff's putters and YCbCr tables,
  csrc/tiff_decode.cc);
- ``convert("RGB")`` (data/convert.py: CIELab through LittleCMS's
  transform, csrc/lab_convert.cc) and ``exif_transpose`` for Orientation
  2-8.

The codecs of libtiff's fax, ThunderScan and log coders are not read here:
``route`` says so by the tags alone, after Pillow's open rules, and those
files go where every other format goes (PIL where it is installed). WebP
in TIFF (50001) is read as far as Pillow reads it (its size) and refused
at load, as Pillow's libtiff, built without the codec, refuses it. Every
refusal raises ValueError, as Pillow refuses the file.
"""

from __future__ import annotations

import ctypes
import struct
import sys
import zlib
from fractions import Fraction
from typing import NamedTuple, Optional, Tuple

import numpy as np

from yolov5m_tpu_torch.data import convert

PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
            b"MM\x00\x2b", b"II\x2b\x00")
II, MM = b"II", b"MM"

COMPRESSION_INFO = {
    1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4", 5: "tiff_lzw",
    6: "tiff_jpeg", 7: "jpeg", 8: "tiff_adobe_deflate", 32771: "tiff_raw_16",
    32773: "packbits", 32809: "tiff_thunderscan", 32946: "tiff_deflate",
    34676: "tiff_sgilog", 34677: "tiff_sgilog24", 34925: "lzma",
    50000: "zstd", 50001: "webp",
}
# the compressions this module reads (WebP: as Pillow's libtiff, built
# without that codec, refuses it at load)
DECODED = {"raw": 1, "tiff_lzw": 5, "tiff_adobe_deflate": 8,
           "tiff_deflate": 32946, "packbits": 32773, "tiff_jpeg": 6,
           "jpeg": 7, "lzma": 34925, "zstd": 50000, "webp": 50001}

# Pillow's OPEN_INFO: (byte order, photometric, sample format, fill order,
# bits per sample, extra samples) -> (mode, rawmode)
OPEN_INFO = {}


def _info(orders, photo, fmt, fill, bps, extra, mode, rawmode):
    for order in orders:
        OPEN_INFO[(order, photo, fmt, fill, bps, extra)] = (mode, rawmode)


_BOTH = (II, MM)
for _photo, _fill, _bps, _mode, _raw in (
        (0, 1, 1, "1", "1;I"), (0, 2, 1, "1", "1;IR"), (1, 1, 1, "1", "1"),
        (1, 2, 1, "1", "1;R"), (0, 1, 2, "L", "L;2I"), (0, 2, 2, "L", "L;2IR"),
        (1, 1, 2, "L", "L;2"), (1, 2, 2, "L", "L;2R"), (0, 1, 4, "L", "L;4I"),
        (0, 2, 4, "L", "L;4IR"), (1, 1, 4, "L", "L;4"), (1, 2, 4, "L", "L;4R"),
        (0, 1, 8, "L", "L;I"), (0, 2, 8, "L", "L;IR"), (1, 1, 8, "L", "L"),
        (1, 2, 8, "L", "L;R"), (3, 1, 1, "P", "P;1"), (3, 2, 1, "P", "P;1R"),
        (3, 1, 2, "P", "P;2"), (3, 2, 2, "P", "P;2R"), (3, 1, 4, "P", "P;4"),
        (3, 2, 4, "P", "P;4R"), (3, 1, 8, "P", "P"), (3, 2, 8, "P", "P;R"),
        (6, 1, 8, "L", "L")):
    _info(_BOTH, _photo, (1,), _fill, (_bps,), (), _mode, _raw)
_info(_BOTH, 1, (2,), 1, (8,), (), "L", "L")
_info((II,), 1, (1,), 1, (12,), (), "I;16", "I;12")
_info((II,), 0, (1,), 1, (16,), (), "I;16", "I;16")
_info((II,), 1, (1,), 1, (16,), (), "I;16", "I;16")
_info((MM,), 1, (1,), 1, (16,), (), "I;16B", "I;16B")
_info((II,), 1, (1,), 2, (16,), (), "I;16", "I;16R")
_info((II,), 1, (2,), 1, (16,), (), "I", "I;16S")
_info((MM,), 1, (2,), 1, (16,), (), "I", "I;16BS")
_info((II,), 0, (3,), 1, (32,), (), "F", "F;32F")
_info((MM,), 0, (3,), 1, (32,), (), "F", "F;32BF")
_info((II,), 1, (1,), 1, (32,), (), "I", "I;32N")
_info((II,), 1, (2,), 1, (32,), (), "I", "I;32S")
_info((MM,), 1, (2,), 1, (32,), (), "I", "I;32BS")
_info((II,), 1, (3,), 1, (32,), (), "F", "F;32F")
_info((MM,), 1, (3,), 1, (32,), (), "F", "F;32BF")
_info(_BOTH, 1, (1,), 1, (8, 8), (2,), "LA", "LA")
_info(_BOTH, 2, (1,), 1, (8, 8, 8), (), "RGB", "RGB")
_info(_BOTH, 2, (1,), 2, (8, 8, 8), (), "RGB", "RGB;R")
_info(_BOTH, 2, (1,), 1, (8, 8, 8, 8), (), "RGBA", "RGBA")
for _extra, _mode, _raw in (
        ((0,), "RGB", "RGBX"), ((0, 0), "RGB", "RGBXX"),
        ((0, 0, 0), "RGB", "RGBXXX"), ((1,), "RGBA", "RGBa"),
        ((1, 0), "RGBA", "RGBaX"), ((1, 0, 0), "RGBA", "RGBaXX"),
        ((2,), "RGBA", "RGBA"), ((2, 0), "RGBA", "RGBAX"),
        ((2, 0, 0), "RGBA", "RGBAXX"), ((999,), "RGBA", "RGBA")):
    _info(_BOTH, 2, (1,), 1, (8,) * (3 + len(_extra)), _extra, _mode, _raw)
for _order, _end in ((II, "L"), (MM, "B")):
    _info((_order,), 2, (1,), 1, (16,) * 3, (), "RGB", "RGB;16" + _end)
    _info((_order,), 2, (1,), 1, (16,) * 4, (), "RGBA", "RGBA;16" + _end)
    _info((_order,), 2, (1,), 1, (16,) * 4, (0,), "RGB", "RGBX;16" + _end)
    _info((_order,), 2, (1,), 1, (16,) * 4, (1,), "RGBA", "RGBa;16" + _end)
    _info((_order,), 2, (1,), 1, (16,) * 4, (2,), "RGBA", "RGBA;16" + _end)
    _info((_order,), 5, (1,), 1, (16,) * 4, (), "CMYK", "CMYK;16" + _end)
_info(_BOTH, 3, (1,), 1, (8, 8), (0,), "P", "PX")
_info(_BOTH, 3, (1,), 1, (8, 8), (2,), "PA", "PA")
_info(_BOTH, 5, (1,), 1, (8,) * 4, (), "CMYK", "CMYK")
_info(_BOTH, 5, (1,), 1, (8,) * 5, (0,), "CMYK", "CMYKX")
_info(_BOTH, 5, (1,), 1, (8,) * 6, (0, 0), "CMYK", "CMYKXX")
_info(_BOTH, 6, (1,), 1, (8,) * 3, (), "RGB", "RGBX")
_info(_BOTH, 8, (1,), 1, (8,) * 3, (), "LAB", "LAB")

MAX_SAMPLESPERPIXEL = max(len(key[4]) for key in OPEN_INFO)
MAX_PIXELS = 89478485               # PIL.Image.MAX_IMAGE_PIXELS
MAPMODES = ("L", "P", "RGBX", "RGBA", "CMYK", "I;16", "I;16L", "I;16B")

# tags
IMAGEWIDTH, IMAGELENGTH, BITSPERSAMPLE, COMPRESSION = 256, 257, 258, 259
PHOTOMETRIC, FILLORDER, STRIPOFFSETS, ORIENTATION = 262, 266, 273, 274
SAMPLESPERPIXEL, ROWSPERSTRIP, STRIPBYTECOUNTS = 277, 278, 279
PLANAR, PREDICTOR, COLORMAP = 284, 317, 320
TILEWIDTH, TILELENGTH, TILEOFFSETS, TILEBYTECOUNTS = 322, 323, 324, 325
EXTRASAMPLES, SAMPLEFORMAT = 338, 339
JPEGTABLES, YCBCRCOEFFICIENTS, YCBCRSUBSAMPLING = 347, 529, 530
REFERENCEBLACKWHITE = 532
# the old-style JPEG codec's tags (tif_ojpeg.c)
JPEGIFOFFSET, JPEGIFBYTECOUNT, JPEGRESTARTINTERVAL = 513, 514, 515
JPEGQTABLES, JPEGDCTABLES, JPEGACTABLES = 519, 520, 521
WINDOWS_MEDIA_PHOTO = 0xBC01
# TiffTags' length of each tag the open reads (1: one value; 0: a tuple)
# and the enum names an ASCII value is looked up in
LENGTH_ONE = (IMAGEWIDTH, IMAGELENGTH, COMPRESSION, PHOTOMETRIC, FILLORDER,
              ORIENTATION, SAMPLESPERPIXEL, ROWSPERSTRIP, PLANAR, TILEWIDTH,
              TILELENGTH)
ENUMS = {
    COMPRESSION: {"Uncompressed": 1, "CCITT 1d": 2, "Group 3 Fax": 3,
                  "Group 4 Fax": 4, "LZW": 5, "JPEG": 6, "PackBits": 32773},
    PHOTOMETRIC: {"WhiteIsZero": 0, "BlackIsZero": 1, "RGB": 2,
                  "RGB Palette": 3, "Transparency Mask": 4, "CMYK": 5,
                  "YCbCr": 6, "CieLAB": 8, "CFA": 32803, "LinearRaw": 32892},
    PLANAR: {"Contiguous": 1, "Separate": 2},
}
# ImageFileDirectory_v2's loaders: type -> (unit size, struct code or kind)
TYPES = {1: (1, "byte"), 2: (1, "ascii"), 3: (2, "H"), 4: (4, "L"),
         5: (8, "rational"), 6: (1, "b"), 7: (1, "undefined"), 8: (2, "h"),
         9: (4, "l"), 10: (8, "srational"), 11: (4, "f"), 12: (8, "d"),
         13: (4, "L"), 16: (8, "Q")}


class NotTiff(Exception):
    """Pillow's TIFF plugin raises SyntaxError on the file (or an error its
    open turns into one: a missing size, a mode OPEN_INFO lacks, a
    compression COMPRESSION_INFO lacks), so Pillow's open goes on to its
    other plugins."""


def accepts(prefix: bytes) -> bool:
    """Pillow's TIFF ``_accept``: one of the six PREFIXES."""
    return bytes(prefix[:4]) in PREFIXES


# -- Pillow's open ----------------------------------------------------------

class Ifd:
    """IFD0 as Pillow's ``ImageFileDirectory_v2.load`` reads it: the raw
    entries (type, data) of every tag of a type it knows whose data lie
    in the file, in the order read; values decoded on demand as its
    ``__getitem__`` does."""

    def __init__(self, data: bytes, endian: str, bigtiff: bool, offset: int):
        self.endian, self.bigtiff, self.offset = endian, bigtiff, offset
        self.entries = {}
        self._values = {}
        pos = offset
        try:
            n, pos = self._read(data, pos, "Q" if bigtiff else "H")
            for _ in range(n):
                size = 20 if bigtiff else 12
                if pos + size > len(data):
                    raise OSError("Corrupt EXIF data")
                entry = data[pos:pos + size]
                tag, typ = struct.unpack(endian + "HH", entry[:4])
                count = struct.unpack(endian + ("Q" if bigtiff else "L"),
                                      entry[4:12 if bigtiff else 8])[0]
                inline = entry[12 if bigtiff else 8:]
                pos += size
                if typ not in TYPES:
                    continue
                nbytes = count * TYPES[typ][0]
                if nbytes > (8 if bigtiff else 4):
                    at = struct.unpack(endian + ("Q" if bigtiff else "L"),
                                       inline)[0]
                    value = data[at:at + nbytes]
                    if len(value) < nbytes:
                        raise OSError("Truncated File Read")
                else:
                    value = inline[:nbytes]
                if not value:
                    continue
                self.entries[tag] = (typ, value)
            self._read(data, pos, "Q" if bigtiff else "L")      # next IFD
        except OSError:
            pass

    def _read(self, data, pos, code):
        size = struct.calcsize(self.endian + code)
        if pos + size > len(data) or pos < 0:
            raise OSError("Corrupt EXIF data")
        return struct.unpack(self.endian + code, data[pos:pos + size])[0], \
            pos + size

    def __contains__(self, tag) -> bool:
        return tag in self.entries

    def __getitem__(self, tag):
        if tag not in self._values:
            self._values[tag] = self._decode(tag)
        return self._values[tag]

    def get(self, tag, default=None):
        return self[tag] if tag in self.entries else default

    def _decode(self, tag):
        typ, raw = self.entries[tag]
        unit, kind = TYPES[typ]
        if kind in ("byte", "undefined"):
            values = (raw,)
        elif kind == "ascii":
            text = raw[:-1] if raw.endswith(b"\0") else raw
            values = (ENUMS.get(tag, {}).get(text.decode("latin-1"),
                                             text.decode("latin-1")),)
        elif kind in ("rational", "srational"):
            code = "L" if kind == "rational" else "l"
            nums = struct.unpack(f"{self.endian}{len(raw) // 4}{code}", raw)
            values = tuple(Fraction(a, b) if b else float("nan")
                           for a, b in zip(nums[::2], nums[1::2]))
        else:
            values = struct.unpack(f"{self.endian}{len(raw) // unit}{kind}",
                                   raw)
        if tag in LENGTH_ONE or typ == 1:
            return values[0]
        return tuple(values)


class Tile(NamedTuple):
    extents: Tuple[int, int, int, int]      # x0, y0, x1, y1
    offset: int
    rawmode: str
    stride: int


class Header(NamedTuple):
    mode: str
    rawmode: str
    size: Tuple[int, int]         # (w, h) as Image.open(...).size reads it
    tile_size: Tuple[int, int]    # (w, h) of the stored image
    compression: str
    photometric: object
    orientation: object
    tiles: tuple                  # the raw route's tile list
    palette: Optional[bytes]      # RGB;L (all reds, greens, blues)


def _header_ifd(data: bytes) -> Ifd:
    """Pillow's ``_open`` up to IFD0's tags."""
    if not accepts(data[:4]):
        raise NotTiff("not a TIFF file")
    ifh = data[:8]
    bigtiff = len(ifh) > 2 and ifh[2] == 43
    if bigtiff:
        ifh = data[:16]
    endian = ">" if ifh[:2] == MM else "<"
    try:
        first = struct.unpack(endian + ("Q" if bigtiff else "L"),
                              ifh[8:] if bigtiff else ifh[4:])[0]
    except struct.error as e:
        raise NotTiff(str(e)) from e
    if not first:
        raise NotTiff("no more images in TIFF file")
    if first >= 2 ** 63:
        raise ValueError("Unable to seek to frame")
    return Ifd(data, endian, bigtiff, first)


def _setup(ifd: Ifd) -> Header:
    """Pillow's ``_setup`` of IFD0 (the raw route's tile list included)."""
    if WINDOWS_MEDIA_PHOTO in ifd:
        raise ValueError("Windows Media Photo files not yet supported")
    compression = COMPRESSION_INFO[ifd.get(COMPRESSION, 1)]
    planar = ifd.get(PLANAR, 1)
    photo = ifd.get(PHOTOMETRIC, 0)
    if compression == "tiff_jpeg":
        photo = 6
    fillorder = ifd.get(FILLORDER, 1)
    try:
        xsize, ysize = ifd[IMAGEWIDTH], ifd[IMAGELENGTH]
    except KeyError as e:
        raise TypeError("Missing dimensions") from e
    if not isinstance(xsize, int) or not isinstance(ysize, int):
        raise ValueError("Invalid dimensions")
    orientation = ifd.get(ORIENTATION)
    size = (ysize, xsize) if orientation in (5, 6, 7, 8) else (xsize, ysize)

    sample_format = ifd.get(SAMPLEFORMAT, (1,))
    if len(sample_format) > 1 and max(sample_format) == min(sample_format) \
            == 1:
        sample_format = (1,)
    bps_tuple = ifd.get(BITSPERSAMPLE, (1,))
    extra_tuple = ifd.get(EXTRASAMPLES, ())
    if photo in (2, 6, 8):
        bps_count = 3
    elif photo == 5:
        bps_count = 4
    else:
        bps_count = 1
    bps_count += len(extra_tuple)
    bps_actual_count = len(bps_tuple)
    samples_per_pixel = ifd.get(
        SAMPLESPERPIXEL,
        3 if compression == "tiff_jpeg" and photo in (2, 6) else 1)
    if samples_per_pixel > MAX_SAMPLESPERPIXEL:
        raise SyntaxError("Invalid value for samples per pixel")
    if samples_per_pixel < bps_actual_count:
        bps_tuple = bps_tuple[:samples_per_pixel]
    elif samples_per_pixel > bps_actual_count and bps_actual_count == 1:
        bps_tuple = bps_tuple * samples_per_pixel
    if len(bps_tuple) != samples_per_pixel:
        raise SyntaxError("unknown data organization")
    key = (ifd.endian == ">" and MM or II, photo, sample_format, fillorder,
           bps_tuple, extra_tuple)
    try:
        mode, rawmode = OPEN_INFO[key]
    except KeyError as e:
        raise SyntaxError("unknown pixel mode") from e

    tiles = []
    if compression != "raw":
        if fillorder == 2:
            mode, rawmode = OPEN_INFO[key[:3] + (1,) + key[4:]]
        # YCbCr under JPEG in one plane: libjpeg converts it to RGB
        if photo == 6 and compression == "jpeg" and planar == 1:
            rawmode = "RGB"
        elif rawmode == "I;16":
            rawmode = "I;16N"
        elif rawmode.endswith((";16B", ";16L")):
            rawmode = rawmode[:-1] + "N"
    elif STRIPOFFSETS in ifd or TILEOFFSETS in ifd:
        if STRIPOFFSETS in ifd:
            offsets = ifd[STRIPOFFSETS]
            h = ifd.get(ROWSPERSTRIP, ysize)
            w = xsize
        else:
            offsets = ifd[TILEOFFSETS]
            w, h = ifd.get(TILEWIDTH), ifd.get(TILELENGTH)
            if not isinstance(w, int) or not isinstance(h, int):
                raise ValueError("Invalid tile dimensions")
        if w == xsize and h == ysize and planar != 2:
            offsets = offsets[-1:]
        x = y = layer = 0
        for offset in offsets:
            stride = w * sum(bps_tuple) / 8 if x + w > xsize else 0
            tile_rawmode = rawmode
            if planar == 2:
                tile_rawmode = rawmode[layer]
                stride /= bps_count
            tiles.append(Tile((x, y, min(x + w, xsize), min(y + h, ysize)),
                              offset, tile_rawmode, int(stride)))
            x += w
            if x >= xsize:
                x, y = 0, y + h
                if y >= ysize:
                    y = 0
                    layer += 1
    else:
        raise SyntaxError("unknown data organization")

    palette = None
    if mode in ("P", "PA"):
        palette = b"".join(bytes(((b // 256) & 255,))
                           for b in ifd[COLORMAP])
    return Header(mode, rawmode, size, (xsize, ysize), compression, photo,
                  orientation, tuple(tiles), palette)


class FileView:
    """A file's bytes as open_tiff reads them (len and slices), read from
    the file where they lie: a size needs IFD0, wherever the writer put
    it, and not the pixel data."""

    def __init__(self, f):
        self.f = f
        f.seek(0, 2)
        self.n = f.tell()

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, s: slice) -> bytes:
        start = s.start or 0
        stop = self.n if s.stop is None else min(s.stop, self.n)
        self.f.seek(start)
        return self.f.read(max(0, stop - start))


def open_tiff(data) -> Header:
    """What Pillow's ``Image.open`` reads of a TIFF file. Raises NotTiff
    where the plugin passes the file on (SyntaxError, or IndexError,
    TypeError, KeyError, EOFError or struct.error, which Pillow's
    ImageFile turns into one; a size below 1), ValueError where the open
    fails (a bad size or tile size, the decompression-bomb limit). data:
    the file's bytes or a FileView of it."""
    if not isinstance(data, FileView):
        data = bytes(data)
    try:
        header = _setup(_header_ifd(data))
    except (SyntaxError, IndexError, TypeError, KeyError, EOFError,
            struct.error) as e:
        raise NotTiff(str(e)) from e
    w, h = header.size
    if w <= 0 or h <= 0:
        raise NotTiff("a size below 1")
    _bomb_check(header.size)
    return header


def _bomb_check(size) -> None:
    if max(1, size[0]) * max(1, size[1]) > 2 * MAX_PIXELS:
        raise ValueError("past the decompression-bomb limit")


def size(data: bytes) -> Tuple[int, int]:
    """(h, w) as Pillow's open reads it (the IFD alone; Orientation 5-8
    swaps them)."""
    w, h = open_tiff(data).size
    return h, w


def route(header: Header, data: bytes) -> Optional[str]:
    """"raw" or "libtiff" for a file this module decodes; None where the
    compression, as Pillow's open reads it or as libtiff reads it at load
    (the first of duplicate tags, where Pillow takes the last), is left to
    the route other formats take."""
    if header.compression not in DECODED:
        return None
    if header.compression == "raw":
        return "raw"
    try:
        ldir = libtiff_dir(data)
    except ValueError:
        return "libtiff"                # refused at load
    if ldir.compression not in DECODED.values():
        return None
    return "libtiff"


# -- Pillow's unpackers -------------------------------------------------------

# storage: Pillow's own image memory, as numpy. Modes of 4-byte pixels
# (LA, PA, RGB, RGBA, CMYK, LAB) are (h, w, 4) uint8; L, P and 1 (h, w)
# uint8; I;16 (h, w) <u2, I;16B (h, w) >u2, I (h, w) int32, F float32
FOUR = ("LA", "PA", "RGB", "RGBA", "CMYK", "LAB")
_STORAGE = {"1": np.uint8, "L": np.uint8, "P": np.uint8, "I;16": "<u2",
            "I;16B": ">u2", "I": np.int32, "F": np.float32}
# a band unpacker ("R", "G", ... as Pillow's single-band rawmodes) for a
# mode of 4-byte pixels: the byte it writes
BANDS = {"RGB": "RGB", "RGBA": "RGBA", "CMYK": "CMYK", "LAB": "LAB"}
_BITFLIP = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _new(mode: str, w: int, h: int) -> np.ndarray:
    if mode in FOUR:
        return np.zeros((h, w, 4), np.uint8)
    return np.zeros((h, w), _STORAGE[mode])


def rawmode_bits(mode: str, rawmode: str) -> int:
    """The bits a pixel of rawmode takes (the unpacker's), or raises
    ValueError where Pillow has no such unpacker for the mode."""
    if len(rawmode) == 1:
        if (mode in BANDS and rawmode in BANDS[mode]) or \
                (mode, rawmode) in (("L", "L"), ("P", "L"), ("P", "P")):
            return 8
        if (mode, rawmode) in (("I", "I"), ("F", "F")):
            return 32
        if (mode, rawmode) == ("1", "1"):
            return 1
        raise ValueError("unknown raw mode for given image mode")
    if rawmode in _BITS:
        return _BITS[rawmode]
    raise ValueError("unknown raw mode for given image mode")


_BITS = {"1": 1, "1;I": 1, "1;R": 1, "1;IR": 1, "L;2": 2, "L;2I": 2,
         "L;2R": 2, "L;2IR": 2, "L;4": 4, "L;4I": 4, "L;4R": 4, "L;4IR": 4,
         "L;I": 8, "L": 8, "L;R": 8, "I;12": 12, "I;16": 16,
         "I;16N": 16, "I;16R": 16, "I;16B": 16, "I;16S": 16, "I;16BS": 16,
         "I;32N": 32, "I;32S": 32, "I;32BS": 32, "F;32F": 32, "F;32BF": 32,
         "LA": 16, "PA": 16, "RGB": 24, "RGB;R": 24, "RGBA": 32, "RGBX": 32,
         "RGBXX": 40, "RGBXXX": 48, "RGBa": 32, "RGBaX": 40, "RGBaXX": 48,
         "RGBAX": 40, "RGBAXX": 48, "RGB;16L": 48, "RGB;16B": 48,
         "RGB;16N": 48, "RGBA;16L": 64, "RGBA;16B": 64, "RGBA;16N": 64,
         "RGBX;16L": 64, "RGBX;16B": 64, "RGBX;16N": 64, "RGBa;16L": 64,
         "RGBa;16B": 64, "RGBa;16N": 64, "P;1": 1, "P;2": 2, "P;4": 4, "P": 8, "PX": 16, "P;R": 8,
         "CMYK": 32, "CMYKX": 40, "CMYKXX": 48, "CMYK;16L": 64,
         "CMYK;16B": 64, "CMYK;16N": 64, "LAB": 24}


def _bits(rows: np.ndarray, n: int, width: int) -> np.ndarray:
    """Samples of n bits, MSB first, from (r, bytes) rows: (r, width)."""
    bits = np.unpackbits(rows, axis=1)[:, :width * n]
    bits = bits.reshape(rows.shape[0], width, n).astype(np.uint8)
    out = np.zeros(bits.shape[:2], np.uint8)
    for i in range(n):
        out = (out << 1) | bits[..., i]
    return out


def _unpremultiply(c: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Pillow's RGBa unpacker: CLIP8(c * 255 / a), 0 where a is 0."""
    c, a = c.astype(np.int32), a.astype(np.int32)
    out = np.minimum(c * 255 // np.maximum(a, 1), 255)
    return np.where(a == 0, 0, np.where(a == 255, c, out)).astype(np.uint8)


def unpack(mode: str, rawmode: str, rows: np.ndarray, width: int,
           store: np.ndarray) -> None:
    """Pillow's unpacker of rawmode for mode, from (r, >= row bytes) uint8
    rows, into store ((r, width) or (r, width, 4) storage): writes only
    what Pillow's unpacker writes."""
    r = rows.shape[0]
    if len(rawmode) == 1 and mode in BANDS:            # one band, copied
        store[..., BANDS[mode].index(rawmode)] = rows[:, :width]
        return
    if rawmode in ("1", "1;I", "1;R", "1;IR"):
        v = rows[:, :(width + 7) // 8]
        if rawmode.endswith("R"):
            v = _BITFLIP[v]
        bits = np.unpackbits(v, axis=1)[:, :width]
        if "I" in rawmode:
            bits = 1 - bits
        store[...] = bits * 255
        return
    if rawmode[:2] in ("L;", "P;") and rawmode[2:3] in ("2", "4"):
        n = int(rawmode[2])
        v = rows[:, :(width * n + 7) // 8]
        if rawmode.endswith("R"):
            v = _BITFLIP[v]
        s = _bits(v, n, width)
        if "I" in rawmode[3:]:
            s = (1 << n) - 1 - s
        store[...] = s * (255 // ((1 << n) - 1)) if mode == "L" else s
        return
    if rawmode in ("P;1", "P;1R"):
        v = rows[:, :(width + 7) // 8]
        if rawmode.endswith("R"):
            v = _BITFLIP[v]
        store[...] = np.unpackbits(v, axis=1)[:, :width]
        return
    if rawmode in ("L", "P", "L;I", "L;R", "L;IR", "P;R"):
        v = rows[:, :width]
        if rawmode.endswith("R"):
            v = _BITFLIP[v]
        store[...] = 255 - v if "I" in rawmode else v
        return
    if mode in ("I;16", "I;16B", "I", "F"):
        store[...] = _wide(rawmode, rows, width)
        return
    if rawmode in ("LA", "PA", "PX"):
        v = rows[:, :width * 2].reshape(r, width, 2)
        if rawmode == "PX":
            store[...] = v[..., 0]
        else:
            store[..., 0] = v[..., 0]
            store[..., 1] = v[..., 0]
            store[..., 2] = v[..., 0]
            store[..., 3] = v[..., 1]
        return
    if rawmode == "LAB":
        v = rows[:, :width * 3].reshape(r, width, 3)
        store[..., 0] = v[..., 0]
        store[..., 1:3] = v[..., 1:3] ^ 128
        return
    wide = ";16" in rawmode
    base = rawmode.split(";")[0]
    step = len(base) * (2 if wide else 1)
    v = rows[:, :width * step].reshape(r, width, len(base), 2 if wide else 1)
    if wide:
        hi = 1 if rawmode.endswith("L") or (
            rawmode.endswith("N") and sys.byteorder == "little") else 0
        v = v[..., hi]
    else:
        v = v[..., 0]
    if rawmode == "RGB;R":
        v = _BITFLIP[v]
    if base.startswith("RGBa"):
        a = v[..., 3]
        for i in range(3):
            store[..., i] = _unpremultiply(v[..., i], a)
        store[..., 3] = a
        return
    n = 4 if base.startswith(("RGBA", "CMYK")) else 3
    store[..., :n] = v[..., :n]
    if n == 3:
        store[..., 3] = 255


def _wide(rawmode: str, rows: np.ndarray, width: int) -> np.ndarray:
    """The 12-, 16- and 32-bit grey and float unpackers."""
    r = rows.shape[0]
    if rawmode == "I;12":
        v = rows[:, :(width * 12 + 7) // 8].astype(np.uint16)
        pad = np.zeros((r, (width + 1) // 2 * 3), np.uint16)
        pad[:, :v.shape[1]] = v
        t = pad.reshape(r, -1, 3)
        first = (t[..., 0] << 4) | (t[..., 1] >> 4)
        second = ((t[..., 1] & 15) << 8) | t[..., 2]
        return np.stack([first, second], -1).reshape(r, -1)[:, :width]
    code = {"I;16": "<u2", "I;16N": "=u2", "I;16R": "<u2", "I;16B": ">u2",
            "I;16S": "<i2", "I;16BS": ">i2", "I;32N": "=u4", "I;32S": "<i4",
            "I;32BS": ">i4", "F;32F": "<f4", "F;32BF": ">f4", "I": "=i4",
            "F": "=f4"}[rawmode]
    size = int(code[2])
    v = np.ascontiguousarray(rows[:, :width * size])
    if rawmode == "I;16R":
        v = _BITFLIP[v]
    return v.view(code).reshape(r, width)


# -- the raw route (Compression 1): Pillow's ImageFile.load ----------------

_MAP_BYTES = {"L": 1, "P": 1, "I;16": 2, "I;16L": 2, "I;16B": 2}


def _load_raw(data: bytes, header: Header, by_path: bool) -> np.ndarray:
    """The image's storage as Pillow's raw route leaves it. by_path: the
    file was opened by its path, so Pillow memory-maps a single tile whose
    rawmode is the mode (at the size open reports: Orientation 5-8 read
    with the sides swapped)."""
    mode, tiles = header.mode, list(header.tiles)
    if by_path and len(tiles) == 1 and tiles[0].rawmode == mode and \
            mode in MAPMODES:
        t = tiles[0]
        if t.offset < 0:
            raise ValueError("Tile offset cannot be negative")
        w, h = header.size
        if not t.offset + h * t.stride > len(data):
            stride = t.stride if t.stride > 0 else w * _MAP_BYTES.get(mode, 4)
            if t.offset + h * stride > len(data):
                raise ValueError("buffer is not large enough")
            rows = np.frombuffer(data, np.uint8, h * stride, t.offset)
            return _frombuffer(mode, rows.reshape(h, stride), w)
    w, h = header.tile_size
    store = _new(mode, w, h)
    tiles.sort(key=lambda t: t.offset)
    kept = []
    for t in tiles:             # consecutive duplicates: the last one
        if kept and kept[-1][:1] + kept[-1][2:] == t[:1] + t[2:]:
            kept[-1] = t
        else:
            kept.append(t)
    err = -3
    for t in kept:
        if t.offset < 0:
            raise ValueError("negative seek value")
        bits = rawmode_bits(mode, t.rawmode)
        x0, y0, x1, y1 = t.extents
        if x0 == 0 and x1 == 0:
            x0, y0, x1, y1 = 0, 0, w, h
        tw, th = x1 - x0, y1 - y0
        if tw <= 0 or th <= 0 or x1 > w or y1 > h:
            raise ValueError("tile cannot extend outside image")
        row = (tw * bits + 7) // 8
        skip = t.stride - row if t.stride else 0
        if skip < 0:
            err = -8                    # IMAGING_CODEC_CONFIG
            continue
        need = th * row + (th - 1) * skip
        if len(data) - t.offset < need:
            raise ValueError("image file is truncated")
        pitch = row + skip
        buf = np.frombuffer(data, np.uint8, need + skip, t.offset) \
            if t.offset + need + skip <= len(data) else np.frombuffer(
                data[t.offset:t.offset + need] + bytes(skip), np.uint8)
        rows = buf.reshape(th, pitch)[:, :row]
        unpack(mode, t.rawmode, rows, tw, store[y0:y1, x0:x1])
        err = 0
    if err < 0:
        raise ValueError(f"decoder error {err}")
    return store


def _frombuffer(mode: str, rows: np.ndarray, w: int) -> np.ndarray:
    """A mapped image: rows (h, stride) of the mode's own storage."""
    h = rows.shape[0]
    if mode in FOUR:
        return np.ascontiguousarray(rows[:, :w * 4]).reshape(h, w, 4)
    dtype = np.dtype(_STORAGE[mode])
    return np.ascontiguousarray(rows[:, :w * dtype.itemsize]).view(
        dtype).reshape(h, w)


# -- the libtiff route: libtiff's directory, Pillow's TiffDecode.c -----------

class LibtiffDir(NamedTuple):
    width: int
    length: int
    bps: int
    spp: int
    compression: int
    photometric: Optional[int]
    fillorder: int
    planar: int
    rowsperstrip: Optional[int]    # None where the tag is absent
    tiled: bool
    tilewidth: int
    tilelength: int
    predictor: int
    sampleformat: int
    extrasamples: tuple
    offsets: tuple
    counts: tuple
    swap: bool
    subsampling: tuple = (2, 2)    # YCbCrSubsampling (libtiff's default)
    coefficients: tuple = (0.299, 0.587, 0.114)   # float32 values
    refbw: Optional[tuple] = None  # ReferenceBlackWhite, None: the default
    tables: Optional[bytes] = None  # JPEGTables
    ojpeg: Optional[tuple] = None  # Compression 6: _ojpeg_tags' values


_INT_TYPES = {1: "B", 6: "b", 3: "H", 8: "h", 4: "L", 9: "l", 16: "Q",
              17: "q", 13: "L", 18: "Q"}
_IFD_TYPES = (13, 18)         # read as offsets only (the strile arrays)
_WIDTHS = {1: 1, 2: 1, 6: 1, 7: 1, 3: 2, 8: 2, 4: 4, 9: 4, 11: 4, 13: 4,
           5: 8, 10: 8, 12: 8, 16: 8, 17: 8, 18: 8}


class _Entries:
    """libtiff's TIFFFetchDirectory of IFD0 and its TIFFReadDirEntry*
    readers: integers of any integer type, held to the value's range."""

    def __init__(self, data: bytes, endian: str, big: bool, off: int):
        self.data, self.endian, self.big = data, endian, big
        n_size, entry = (8, 20) if big else (2, 12)
        if off > len(data) - n_size:
            raise ValueError("Can not read TIFF directory count")
        n = struct.unpack_from(endian + ("Q" if big else "H"), data, off)[0]
        if n > 4096:
            raise ValueError("Sanity check on directory count failed")
        if n * entry > len(data) - off - n_size:
            raise ValueError("Can not read TIFF directory")
        self.all = []               # (tag, type, count, value field)
        for i in range(n):
            at = off + n_size + i * entry
            tag, typ = struct.unpack_from(endian + "HH", data, at)
            count = struct.unpack_from(endian + ("Q" if big else "L"), data,
                                       at + 4)[0]
            field = data[at + (12 if big else 8):at + entry]
            self.all.append((tag, typ, count, field))
        # a tag's later duplicates are ignored (bugzilla 1994)
        self.tags = {}
        for e in self.all:
            self.tags.setdefault(e[0], e)
        self.order = [e for e in self.all if self.tags[e[0]] is e]

    def array(self, e, limit: Optional[int] = None, lo: int = 0,
              hi: int = 2 ** 64 - 1, offsets: bool = False) -> list:
        tag, typ, count, field = e
        if typ not in _INT_TYPES or (typ in _IFD_TYPES and not offsets):
            raise ValueError(f"tag {tag}: wrong type")
        width = _WIDTHS[typ]
        want = count if limit is None else min(count, limit)
        if min(count, 10) * width <= (8 if self.big else 4):
            raw = field[:want * width]
        else:
            at = struct.unpack(self.endian + ("Q" if self.big else "L"),
                               field)[0]
            if at + want * width > len(self.data):
                raise ValueError(f"tag {tag}: data past the end")
            raw = self.data[at:at + want * width]
        values = list(struct.unpack(
            f"{self.endian}{want}{_INT_TYPES[typ]}", raw))
        if any(v < lo or v > hi for v in values):
            raise ValueError(f"tag {tag}: value out of range")
        return values

    def one(self, e, hi: int) -> int:
        if e[2] != 1:
            raise ValueError(f"tag {e[0]}: count {e[2]}")
        return self.array(e, hi=hi)[0]

    def persample(self, e, spp: int) -> int:
        if e[2] != 1 and e[2] < spp:
            raise ValueError(f"tag {e[0]}: count {e[2]}")
        if e[2] == 1:
            return self.one(e, 65535)
        values = self.array(e, hi=65535)[:spp]
        if any(v != values[0] for v in values):
            raise ValueError(f"tag {e[0]}: samples differ")
        return values[0]


def _howmany(a: int, b: int) -> int:
    return -(-a // b)


def _color_channels(photometric) -> int:
    return {0: 1, 1: 1, 3: 1, 2: 3, 6: 3, 8: 3, 9: 3, 10: 3, 32845: 3,
            5: 4, 4: 4}.get(photometric, 0)


def libtiff_dir(data: bytes) -> LibtiffDir:
    """libtiff 4.7.1's TIFFClientOpen and TIFFReadDirectory of IFD0, as far
    as the decode depends on them. Raises ValueError where libtiff fails
    the open."""
    if len(data) < 8 or data[:2] not in (II, MM):
        raise ValueError("Not a TIFF file, bad magic number")
    endian = ">" if data[:2] == MM else "<"
    version = struct.unpack_from(endian + "H", data, 2)[0]
    if version == 43:
        if len(data) < 16:
            raise ValueError("Cannot read TIFF header")
        size8, unused = struct.unpack_from(endian + "HH", data, 4)
        if size8 != 8 or unused != 0:
            raise ValueError("Invalid BigTIFF header")
        off = struct.unpack_from(endian + "Q", data, 8)[0]
    elif version == 42:
        off = struct.unpack_from(endian + "L", data, 4)[0]
    else:
        raise ValueError("Not a TIFF file, bad version number")
    d = _Entries(data, endian, version == 43, off)
    tags = d.tags
    spp = d.one(tags[SAMPLESPERPIXEL], 65535) if SAMPLESPERPIXEL in tags \
        else 1
    if spp == 0:
        raise ValueError("SamplesPerPixel 0")
    compression = 1
    if COMPRESSION in tags:
        e = tags[COMPRESSION]
        compression = d.one(e, 65535) if e[2] == 1 else d.persample(e, spp)
    # the first pass, in the directory's order
    width = length = rowsperstrip = None
    tilewidth = tilelength = None
    planar, extrasamples = 1, ()
    for e in d.order:
        tag = e[0]
        if tag == IMAGEWIDTH:
            width = d.one(e, 2 ** 32 - 1)
        elif tag == IMAGELENGTH:
            length = d.one(e, 2 ** 32 - 1)
        elif tag == TILEWIDTH:
            tilewidth = d.one(e, 2 ** 32 - 1)
        elif tag == TILELENGTH:
            tilelength = d.one(e, 2 ** 32 - 1)
        elif tag == PLANAR:
            planar = d.one(e, 65535)
            if planar not in (1, 2):
                raise ValueError("bad PlanarConfiguration")
        elif tag == ROWSPERSTRIP:
            rowsperstrip = d.one(e, 2 ** 32 - 1)
            if rowsperstrip == 0:
                raise ValueError("bad RowsPerStrip")
        elif tag == EXTRASAMPLES:
            if e[2] > 65535:
                raise ValueError("bad ExtraSamples count")
            values = d.array(e, hi=65535)
            if len(values) > spp:
                raise ValueError("more ExtraSamples than samples")
            if any(v > 2 and v != 999 for v in values):
                raise ValueError("bad ExtraSamples value")
            extrasamples = tuple(2 if v == 999 else v for v in values)
    if length is None:
        raise ValueError("TIFF directory is missing required ImageLength")
    # old-style JPEG in planes with one strip offset and one byte count:
    # contiguous, as the codec's files are
    if compression == 6 and planar == 2 and \
            tags.get(STRIPOFFSETS, (0, 0, 0))[2] == 1 and \
            tags.get(STRIPBYTECOUNTS, (0, 0, 0))[2] == 1:
        planar = 1
    width = width or 0
    tiled = tilewidth is not None or tilelength is not None
    rps = 2 ** 32 - 1 if rowsperstrip is None else rowsperstrip
    if tiled:
        tw = width if tilewidth == 2 ** 32 - 1 else (tilewidth or 0)
        th = length if tilelength == 2 ** 32 - 1 else (tilelength or 0)
        nstrips = 0 if not (tw and th) else \
            _howmany(width, tw) * _howmany(length, th)
    else:
        tw, th = width, rps
        nstrips = 1 if rps == 2 ** 32 - 1 else _howmany(length, rps)
    if planar == 2:
        nstrips *= spp
    if not nstrips:
        raise ValueError("Cannot handle zero number of strips")
    offsets_e = tags.get(TILEOFFSETS if TILEOFFSETS in tags else
                         STRIPOFFSETS)
    counts_e = tags.get(TILEBYTECOUNTS if TILEBYTECOUNTS in tags else
                        STRIPBYTECOUNTS)
    # the second pass
    bps, sampleformat, photometric, fillorder, predictor = 1, 1, None, 1, 1
    colormap = False
    for e in d.order:
        tag = e[0]
        if tag == BITSPERSAMPLE:
            bps = d.persample(e, spp)
        elif tag == SAMPLEFORMAT:
            sampleformat = d.persample(e, spp)
            if not 1 <= sampleformat <= 6:
                raise ValueError("bad SampleFormat")
        elif tag in (PHOTOMETRIC, FILLORDER, PREDICTOR):
            try:
                value = d.one(e, 65535)
            except ValueError:
                continue                  # warned and ignored
            if tag == PHOTOMETRIC:
                photometric = value
            elif tag == FILLORDER:
                fillorder = value if value in (1, 2) else fillorder
            elif compression in (5, 8, 32946, 34925, 50000):
                predictor = value
        elif tag == COLORMAP:
            if e[2] == 3 << bps and bps <= 24 and BITSPERSAMPLE in tags \
                    and tags[BITSPERSAMPLE] in d.order[:d.order.index(e)]:
                try:
                    d.array(e, hi=65535)
                    colormap = True
                except ValueError:
                    pass
    if compression == 6:
        # TIFFReadDirectory's defaults for old-style JPEG: YCbCr where the
        # photometric tag is missing or says RGB, 8 bits, 3 (YCbCr) or 1
        # (grey) samples
        if photometric is None or photometric == 2:
            photometric = 6
        if BITSPERSAMPLE not in tags:
            bps = 8
        if SAMPLESPERPIXEL not in tags:
            if photometric == 6:
                spp = 3
            elif photometric in (0, 1):
                spp = 1
    if compression == 6 and planar == 2 and SAMPLESPERPIXEL not in tags:
        nstrips *= spp                  # the strips counted after the hack
    if offsets_e is None and not (compression == 6 and not tiled and
                                  nstrips == 1):
        raise ValueError("TIFF directory is missing required StripOffsets")
    offsets = [0] * nstrips if offsets_e is None else \
        _strile_array(d, offsets_e, nstrips)
    if compression == 6:
        # old-style JPEG: no byte count estimated or fixed (the codec
        # fails to read striles whose arrays are missing)
        counts = [0] * nstrips if counts_e is None else \
            _strile_array(d, counts_e, nstrips)
    elif counts_e is None:
        if (planar == 1 and nstrips > 1) or (planar == 2 and nstrips != spp):
            raise ValueError("missing required StripByteCounts")
        counts = _estimate_counts(d, data, offsets, nstrips, spp, planar)
    else:
        counts = _strile_array(d, counts_e, nstrips)
        if nstrips == 1 and not tiled and offsets[0] != 0 and counts[0] == 0:
            counts = _estimate_counts(d, data, offsets, nstrips, spp, planar)
    color = _color_channels(photometric)
    if color and spp - len(extrasamples) > color:
        extrasamples = extrasamples + (0,) * (spp - color - len(extrasamples))
    if photometric == 3 and not colormap and bps < 8:
        raise ValueError("TIFF directory is missing required Colormap")
    extra = _ycbcr_tags(d, compression)
    if compression == 6:
        extra["ojpeg"] = _ojpeg_tags(d, extra.get("subsampling")) + (
            int(offsets_e is not None and counts_e is not None),)
    if compression == 7 and photometric == 6 and planar == 1 and spp == 3 \
            and "subsampling" not in extra:
        found = _sof_subsampling(data, offsets[0], counts[0], spp)
        if found is not None:
            extra["subsampling"] = found
    ldir = LibtiffDir(width, length, bps, spp, compression, photometric,
                      fillorder, planar, rowsperstrip, tiled, tw, th,
                      predictor, sampleformat, extrasamples, tuple(offsets),
                      tuple(counts), endian != _HOST, **extra)
    if compression == 6:
        ldir = ldir._replace(subsampling=_ojpeg_subsampling(ldir, data))
    if not _scanline(ldir):
        raise ValueError("Cannot handle zero scanline size")
    if not _chunk_size(ldir):
        raise ValueError("Cannot handle zero strip size")
    return ldir


def _ycbcr_tags(d: _Entries, compression: int) -> dict:
    """YCbCrSubsampling, YCbCrCoefficients, ReferenceBlackWhite and (under
    JPEG) JPEGTables as TIFFReadDirectory's TIFFFetchNormalTag
    reads them: the first entry of each, a wrong count, type or value
    ignored (the default stays)."""
    out = {}
    tags = d.tags
    e = tags.get(YCBCRSUBSAMPLING)
    if e is not None and e[2] == 2:
        try:
            out["subsampling"] = tuple(d.array(e, hi=65535))
        except ValueError:
            pass
    for tag, key, n in ((YCBCRCOEFFICIENTS, "coefficients", 3),
                        (REFERENCEBLACKWHITE, "refbw", 6)):
        e = tags.get(tag)
        if e is not None and e[2] == n:
            try:
                out[key] = _floats(d, e)
            except ValueError:
                pass
    e = tags.get(JPEGTABLES)
    if compression == 7 and e is not None and e[2]:
        try:
            out["tables"] = _byte_array(d, e)
        except ValueError:
            pass
    return out


def _ojpeg_tags(d: _Entries, subsampling: Optional[tuple]) -> tuple:
    """The old-style JPEG codec's tags as its OJPEGVSetField keeps them:
    JPEGInterchangeFormat and its length, the three offsets of each of
    JPEGQTables, JPEGDCTables and JPEGACTables (0 past the tag's count; a
    count over 3 ignored), JPEGRestartInterval (0 where absent),
    YCbCrSubsampling (each value as a byte; 2, 2 where not set). A wrong
    type or count leaves the tag unread."""
    tags = d.tags

    def one(tag, hi):
        e = tags.get(tag)
        if e is None or e[2] != 1:
            return 0
        try:
            return d.array(e, hi=hi, offsets=True)[0]
        except ValueError:
            return 0

    def offsets(tag):
        e = tags.get(tag)
        if e is None or e[2] > 3:
            return (0, 0, 0)
        try:
            values = d.array(e, hi=2 ** 64 - 1, offsets=True)
        except ValueError:
            return (0, 0, 0)
        return tuple(values) + (0,) * (3 - len(values))

    sub = (2, 2) if subsampling is None else \
        tuple(v & 255 for v in subsampling)
    return (one(JPEGIFOFFSET, 2 ** 64 - 1), one(JPEGIFBYTECOUNT, 2 ** 64 - 1),
            *offsets(JPEGQTABLES), *offsets(JPEGDCTABLES),
            *offsets(JPEGACTABLES), one(JPEGRESTARTINTERVAL, 65535), *sub)


def _ojpeg_params(ldir: "LibtiffDir", size: int) -> np.ndarray:
    """csrc/jpeg_decode.cc's OjParam values of a file under Compression
    6."""
    o = ldir.ojpeg
    return np.array((size, *o[:12], ldir.width, ldir.length,
                     int(ldir.tiled), ldir.tilewidth, ldir.tilelength,
                     ldir.spp, ldir.planar, ldir.photometric or 0, *o[12:14],
                     _per_plane(ldir), o[14]), np.uint64).view(np.int64)


def _ojpeg_subsampling(ldir: "LibtiffDir", data: bytes) -> tuple:
    """OJPEGSubsamplingCorrect: the YCbCrSubsampling libtiff reports."""
    from yolov5m_tpu_torch.data.native import _as_u8p, decode_lib

    n = len(ldir.offsets)
    hv = np.zeros(2, np.int32)
    i64 = ctypes.c_int64 * n
    decode_lib().tiff_ojpeg_subsampling(
        _as_u8p(np.frombuffer(data, np.uint8)),
        _ojpeg_params(ldir, len(data)).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)),
        i64(*ldir.offsets), i64(*ldir.counts), n,
        hv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return int(hv[0]), int(hv[1])


def _field_bytes(d: _Entries, e, width: int) -> bytes:
    """The bytes of entry e's values (count * width), inline or at their
    offset; ValueError where they run past the end of the file."""
    tag, typ, count, field = e
    size = count * width
    if size <= (8 if d.big else 4):
        return field[:size]
    at = struct.unpack(d.endian + ("Q" if d.big else "L"), field)[0]
    if at + size > len(d.data):
        raise ValueError(f"tag {tag}: data past the end")
    return d.data[at:at + size]


def _floats(d: _Entries, e) -> tuple:
    """TIFFReadDirEntryFloatArray: float32 values of any numeric type; a
    rational with denominator 0 is 0."""
    typ = e[1]
    f32 = np.float32
    if typ in (5, 10):
        raw = _field_bytes(d, e, 8)
        nums = struct.unpack(f"{d.endian}{len(raw) // 4}"
                             f"{'L' if typ == 5 else 'l'}", raw)
        return tuple(f32(0.0) if b == 0 else f32(f32(a) / f32(b))
                     for a, b in zip(nums[::2], nums[1::2]))
    if typ in (11, 12):
        raw = _field_bytes(d, e, 4 if typ == 11 else 8)
        values = np.frombuffer(raw, d.endian + ("f4" if typ == 11 else "f8"))
        if typ == 12:
            big = np.finfo(np.float32).max
            values = np.clip(values, -big, big)
        return tuple(f32(v) for v in values)
    if typ in _INT_TYPES and typ not in _IFD_TYPES:
        return tuple(f32(v) for v in d.array(e, lo=-2 ** 63))
    raise ValueError(f"tag {e[0]}: wrong type")


def _byte_array(d: _Entries, e) -> bytes:
    """TIFFReadDirEntryByteArray: bytes as stored (ASCII, UNDEFINED, BYTE,
    SBYTE at least 0), wider integers held to 0-255."""
    typ = e[1]
    if typ in (1, 2, 7):
        return _field_bytes(d, e, 1)
    if typ in _INT_TYPES and typ not in _IFD_TYPES:
        return bytes(d.array(e, hi=255))
    raise ValueError(f"tag {e[0]}: wrong type")


def _sof_subsampling(data: bytes, offset: int, count: int,
                     spp: int) -> Optional[tuple]:
    """JPEGFixupTagsSubsampling: component 0's sampling factors from the
    first SOF of the first strip or tile (read in 2048-byte blocks within
    its byte count), where the other components are 1x1 and the factors
    are 1, 2 or 4; None where the scan fails or finds none of use."""
    if offset == 0:
        return None
    pos, left = offset, count
    buf = b""

    def byte():
        nonlocal buf, pos, left
        if not buf:
            if left == 0:
                raise EOFError
            n = min(2048, left)
            if pos + n > len(data):
                raise EOFError
            buf, pos, left = data[pos:pos + n], pos + n, left - n
        b, buf = buf[0], buf[1:]
        return b

    def skip(n):
        nonlocal buf, pos, left
        if n <= len(buf):
            buf = buf[n:]
            return
        m = n - len(buf)
        buf = b""
        if m <= left:
            pos, left = pos + m, left - m
        else:
            left = 0

    try:
        while True:
            while byte() != 255:
                pass
            m = byte()
            while m == 255:
                m = byte()
            if m == 0xD8:
                continue
            if m in (0xFE, 0xDB, 0xDA, 0xC4, 0xDD) or 0xE0 <= m <= 0xEF:
                n = byte() << 8 | byte()
                if n < 2:
                    return None
                if n > 2:
                    skip(n - 2)
                continue
            if m not in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA):
                return None
            n = byte() << 8 | byte()
            if n != 8 + spp * 3:
                return None
            skip(7)
            p = byte()
            ph, pv = p >> 4, p & 15
            skip(1)
            for _ in range(1, spp):
                skip(1)
                if byte() != 0x11:
                    return None
                skip(1)
            if ph not in (1, 2, 4) or pv not in (1, 2, 4):
                return None
            return ph, pv
    except EOFError:
        return None


_HOST = "<" if sys.byteorder == "little" else ">"


def _strile_array(d: _Entries, e, nstrips: int) -> list:
    """TIFFFetchStripThing: nstrips values, zeros past the tag's count."""
    values = d.array(e, limit=nstrips, hi=2 ** 63 - 1, offsets=True)
    return values + [0] * (nstrips - len(values))


def _estimate_counts(d: _Entries, data: bytes, offsets: list, nstrips: int,
                     spp: int, planar: int) -> list:
    """EstimateStripByteCounts for a compressed file: the file less the
    header, the directory and its out-of-line values, split over the
    strips; the last one cut at the end of the file."""
    big = d.big
    space = (16 + 8 + len(d.all) * 20 + 8) if big else \
        (8 + 2 + len(d.all) * 12 + 4)
    for tag, typ, count, _ in d.all:
        width = _WIDTHS.get(typ, 0)
        if not width:
            raise ValueError("Cannot determine size of unknown tag type")
        size = width * count
        space += 0 if size <= (8 if big else 4) else size
    space = len(data) - space if len(data) >= space else len(data)
    if planar == 2:
        space //= spp
    counts = [space] * nstrips
    last = offsets[-1]
    if last + counts[-1] > len(data):
        counts[-1] = 0 if last >= len(data) else len(data) - last
    return counts


def _packed(ldir: LibtiffDir, upsampled: bool) -> bool:
    """The chunks hold YCbCr sampling blocks (not upsampled to RGB by the
    JPEG codec's JPEGCOLORMODE_RGB)."""
    return ldir.planar == 1 and ldir.photometric == 6 and not upsampled


def _block_row(ldir: LibtiffDir, width: int) -> int:
    """Bytes of a row of YCbCr sampling blocks, 0 where the subsampling is
    not 1, 2 or 4 each way."""
    h, v = ldir.subsampling
    if h not in (1, 2, 4) or v not in (1, 2, 4):
        return 0
    return _howmany(_howmany(width, h) * (h * v + 2) * ldir.bps, 8)


def _scanline(ldir: LibtiffDir, upsampled: bool = False) -> int:
    """TIFFScanlineSize (0 where the subsampling is invalid)."""
    if _packed(ldir, upsampled) and ldir.spp == 3:
        row = _block_row(ldir, ldir.width)
        return row // ldir.subsampling[1] if row else 0
    bits = ldir.bps * (ldir.spp if ldir.planar == 1 else 1)
    return _howmany(ldir.width * bits, 8)


def _tile_row(ldir: LibtiffDir) -> int:
    """TIFFTileRowSize (never of sampling blocks)."""
    bits = ldir.bps * (ldir.spp if ldir.planar == 1 else 1)
    return _howmany(ldir.tilewidth * bits, 8)


def _rows_size(ldir: LibtiffDir, rows: int, upsampled: bool = False) -> int:
    """TIFFVTileSize or TIFFVStripSize of rows rows."""
    if ldir.tiled:
        if not ldir.tilewidth or not ldir.tilelength:
            return 0
        if _packed(ldir, upsampled) and ldir.spp == 3:
            row = _block_row(ldir, ldir.tilewidth)
            return row * _howmany(rows, ldir.subsampling[1]) if row else 0
        return rows * _tile_row(ldir)
    if _packed(ldir, upsampled):
        row = _block_row(ldir, ldir.width) if ldir.spp == 3 else 0
        return row * _howmany(rows, ldir.subsampling[1]) if row else 0
    return rows * _scanline(ldir, upsampled)


def _chunk_size(ldir: LibtiffDir, upsampled: bool = False) -> int:
    """TIFFTileSize, or TIFFStripSize (rows clamped to the image)."""
    if ldir.tiled:
        return _rows_size(ldir, ldir.tilelength, upsampled)
    return _rows_size(ldir, min(ldir.tilelength, ldir.length), upsampled)


_IMAGE_BANDS = {"1": 1, "L": 1, "P": 1, "I": 1, "F": 1, "I;16": 1,
                "I;16B": 1, "LA": 2, "PA": 2, "RGB": 3, "LAB": 3, "RGBA": 4,
                "CMYK": 4}
_INT_MAX = 2 ** 31 - 1


def _load_libtiff(data: bytes, header: Header) -> np.ndarray:
    """The storage Pillow's libtiff decoder fills (TiffDecode.c over
    libtiff 4.7.1). Raises ValueError where either refuses."""
    ldir = libtiff_dir(data)
    mode, rawmode = header.mode, header.rawmode
    xsize, ysize = header.tile_size
    if (ldir.width, ldir.length) != (xsize, ysize):
        raise ValueError("decoder error -2")
    if ldir.compression not in (5, 6, 7, 8, 32946, 32773, 34925, 50000):
        raise ValueError("decoder error -2")      # WebP: not configured
    predictor = ldir.predictor if ldir.compression != 32773 else 1
    if predictor == 2 and ldir.bps not in (8, 16, 32):
        raise ValueError("Horizontal differencing not supported")
    if predictor == 3 and (ldir.sampleformat != 3 or
                           ldir.bps not in (16, 24, 32, 64)):
        raise ValueError("Floating point predictor not supported")
    if predictor not in (1, 2, 3):
        raise ValueError("Predictor not supported")
    # YCbCr: JPEG in one plane is converted by libjpeg (JPEGCOLORMODE_RGB,
    # the sizes upsampled); every other goes through TIFFRGBAImage
    if ldir.photometric == 6:
        if ldir.compression != 7 or ldir.planar != 1:
            return _load_rgba(data, header, ldir, predictor)
    upsampled = ldir.compression == 7 and ldir.planar == 1 and \
        ldir.photometric == 6
    bits = rawmode_bits(mode, rawmode)
    # planes of a mode of several bands go through RGBA's band unpackers
    separate = ldir.planar == 2 and _IMAGE_BANDS[mode] > 1
    planes = _IMAGE_BANDS[mode] if separate else 1
    chunk_size = _chunk_size(ldir, upsampled)  # TIFFTileSize/StripSize
    if ldir.tiled:
        # _decodeTile's checks, then rows at TIFFTileRowSize
        tw, th = ldir.tilewidth, ldir.tilelength
        tile_bytes, row = chunk_size, _tile_row(ldir)
        if not tile_bytes or not row or row > tile_bytes:
            raise ValueError("decoder error -2")
        if tile_bytes > _INT_MAX - 1 or tw > _INT_MAX or th > _INT_MAX:
            raise ValueError("decoder error -9")
        if tile_bytes > ((th * bits // planes + 7) // 8) * tw:
            raise ValueError("decoder error -2")
        if (tw * (ldir.bps if separate else bits) + 7) // 8 > row:
            # Pillow's unpacker reads past libtiff's tile row, the last
            # row past its buffer: not reproduced, refused
            raise ValueError("an unpacker wider than the tile row")
        chunks = [(tile_index(ldir, x, y, p), (x, y))
                  for y in range(0, ysize, th) for p in range(planes)
                  for x in range(0, xsize, tw)]
    else:
        # _decodeStrip's checks, then rows at TIFFScanlineSize
        rps = ldir.rowsperstrip
        if rps is None or rps == 2 ** 32 - 1:
            rps = ysize
        if rps > _INT_MAX:        # Pillow's INT32 row passes the end: the
            raise ValueError("decoder error -2")   # next strip is past it
        strip_size, row = chunk_size, _scanline(ldir, upsampled)
        if strip_size > _INT_MAX - 1:
            raise ValueError("decoder error -9")
        unpacker_row = (xsize * bits // planes + 7) // 8
        if strip_size > unpacker_row * rps or not row or unpacker_row > row:
            raise ValueError("decoder error -2")
        chunks = [((y // ldir.tilelength) + p * _per_plane(ldir), (0, y))
                  for y in range(0, ysize, rps) for p in range(planes)]
    index = [c for c, _ in chunks]
    if any(i >= len(ldir.offsets) for i in index):
        raise ValueError("decoder error -2")
    occs = [_occ(ldir, i, upsampled) for i in index]
    chain = [k - 1 for k in range(len(index))]
    if ldir.compression == 6:         # the codec reads the file itself
        out, cap, status = _decode_ojpeg(data, ldir, index, occs, chain)
    else:
        fills = [_fill(ldir, data, i, chunk_size) for i in index]
        if any(f is None for f in fills):
            raise ValueError("Read error on strip")
        out, cap, status = _decode(data, ldir, index, fills, occs, predictor,
                                   chain, upsampled)
    if any(status):
        raise ValueError("libtiff refused chunk "
                         f"{next(k for k, v in enumerate(status) if v)}")
    store = _new(mode, xsize, ysize)
    for k, (_, (x, y)) in enumerate(chunks):
        plane = k % planes if not ldir.tiled else \
            (k // _howmany(xsize, ldir.tilewidth)) % planes
        n = occs[k] // row
        rows = out[k * cap:k * cap + n * row].reshape(n, row)
        h = min(n, ysize - y)
        w = min(ldir.tilewidth, xsize - x) if ldir.tiled else xsize
        target = store[y:y + h, x:x + w]
        if separate:
            _unpack_band(mode, plane, ldir.bps, rows[:h], w, target)
        else:
            unpack(mode, rawmode, rows[:h], w, target)
    if separate and mode == "RGBA" and ldir.extrasamples and \
            ldir.extrasamples[0] in (0, 1):
        for i in range(3):
            store[..., i] = _unpremultiply(store[..., i], store[..., 3])
    return store


def _per_plane(ldir: LibtiffDir) -> int:
    """td_stripsperimage: the strips or tiles of one plane."""
    if ldir.tiled:
        return _howmany(ldir.width, ldir.tilewidth) * \
            _howmany(ldir.length, ldir.tilelength)
    return _howmany(ldir.length, min(ldir.tilelength, ldir.length))


def _occ(ldir: LibtiffDir, i: int, upsampled: bool) -> int:
    """The bytes chunk i decodes to: TIFFTileSize, or TIFFVStripSize of
    its rows (fewer in a plane's last strip)."""
    if ldir.tiled:
        return _chunk_size(ldir, upsampled)
    rps = min(ldir.tilelength, ldir.length)
    rows = min(ldir.length - (i % _per_plane(ldir)) * rps, rps)
    return _rows_size(ldir, rows, upsampled)


def _fill(ldir: LibtiffDir, data: bytes, i: int,
          chunk_size: int) -> Optional[Tuple[int, int]]:
    """TIFFFillStrip/Tile's read of chunk i: (offset, byte count), the
    count cut where libtiff cuts it; None where it fails (a count of 0, a
    read past the end of the file)."""
    off, cnt = ldir.offsets[i], ldir.counts[i]
    if cnt == 0 or cnt > 2 ** 63 - 1:
        return None                       # "Invalid strip byte count"
    if cnt > 1024 * 1024 and (cnt - 4096) // 10 > chunk_size:
        cnt = chunk_size * 10 + 4096
    if cnt > len(data) or off > len(data) - cnt:
        return None                       # "Read error on strip"
    return off, cnt


def _decode(data: bytes, ldir: LibtiffDir, index: list, fills: list,
            occs: list, predictor: int, chain: list, upsampled: bool):
    """Chunks index (read as fills[k], None: TIFFFillStrip failed, the slot
    zeroed) decoded in turn by the file's codec into slots of cap bytes,
    each whatever the others did: (the slots, cap, a status a chunk: 0
    decoded, 1 refused, the bytes the codec wrote kept). chain[k]: the
    slot whose bytes slot k starts from (libtiff's buffer, reused; -1: a
    fresh, zeroed buffer), which only the JPEG codec leaves showing."""
    from yolov5m_tpu_torch.data.native import _as_u8p, decode_lib

    n = len(index)
    cap = max(max(occs), 1)
    out = np.zeros(n * cap, np.uint8)
    i64 = ctypes.c_int64 * n
    lib = decode_lib()
    codec = ldir.compression
    live = [k for k in range(n) if fills[k] is not None]
    status = [1] * n
    if codec == 7:
        segs = np.array([_jpeg_segment(ldir, i) for i in index], np.int32)
        info = np.zeros((n, 3), np.int32)
        bpl = _tile_row(ldir) if ldir.tiled else _scanline(ldir, upsampled)
        h, v = ldir.subsampling if ldir.photometric == 6 and \
            ldir.planar == 1 else (1, 1)
        buf = np.frombuffer(data, np.uint8)
        tables = np.frombuffer(ldir.tables or b"\0", np.uint8)
        # a chunk whose read failed: an empty stream (refused at once)
        offsets = [f[0] if f else 0 for f in fills]
        counts = [f[1] if f else 0 for f in fills]
        lib.tiff_jpeg_chunks(
            _as_u8p(buf), _as_u8p(tables),
            -1 if ldir.tables is None else len(ldir.tables),
            i64(*offsets), i64(*counts), i64(*occs),
            segs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            i64(*chain), n, _as_u8p(out), cap, bpl,
            ldir.spp if ldir.planar == 1 else 1, ldir.bps, h, v,
            int(upsampled), info.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32)))
        return out, cap, [int(v) for v in info[:, 0]]
    src = data
    offsets = [fills[k][0] for k in live]
    counts = [fills[k][1] for k in live]
    live_occs = [occs[k] for k in live]
    inflated = None
    if codec in (8, 32946):
        src, offsets, counts, inflated = _inflate(
            data, offsets, counts, live_occs, ldir.fillorder == 2)
        codec = 8
    if not live:
        return out, cap, status
    m = len(live)
    j64 = ctypes.c_int64 * m
    part = np.zeros(m * cap, np.uint8)
    st = (ctypes.c_int64 * m)()
    lib.tiff_decode_chunks(
        _as_u8p(np.frombuffer(src, np.uint8)), j64(*offsets), j64(*counts),
        j64(*live_occs), m, _as_u8p(part), cap, codec, predictor, ldir.bps,
        ldir.spp if ldir.planar == 1 else 1, _tile_row(ldir) if ldir.tiled
        else _scanline(ldir, upsampled), int(ldir.swap),
        int(ldir.fillorder == 2), st)
    for j, k in enumerate(live):
        out[k * cap:(k + 1) * cap] = part[j * cap:(j + 1) * cap]
        status[k] = int(st[j]) or (inflated[j] if inflated else 0)
    return out, cap, status


def _decode_ojpeg(data: bytes, ldir: LibtiffDir, index: list, occs: list,
                  chain: list):
    """Reads of striles index (occs[k] bytes each) in turn, as libtiff's
    old-style JPEG codec makes them on one handle (csrc/jpeg_decode.cc's
    tiff_ojpeg_reads): (the slots, cap, a status a read: 0 decoded, 1 the
    decode failed, 2 OJPEGPreDecode failed; a failed read zeroed). chain
    as _decode's."""
    from yolov5m_tpu_torch.data.native import _as_u8p, decode_lib

    n = len(index)
    cap = max(max(occs), 1)
    out = np.zeros(n * cap, np.uint8)
    per_plane = _per_plane(ldir)
    reads = np.array([(i, i // per_plane, occ) for i, occ in zip(index, occs)],
                     np.int64)
    status = np.zeros(n, np.int32)
    m = len(ldir.offsets)
    i64p = ctypes.POINTER(ctypes.c_int64)
    s64 = ctypes.c_int64 * m
    decode_lib().tiff_ojpeg_reads(
        _as_u8p(np.frombuffer(data, np.uint8)),
        _ojpeg_params(ldir, len(data)).ctypes.data_as(i64p),
        s64(*ldir.offsets), s64(*ldir.counts), m,
        reads.ctypes.data_as(i64p), (ctypes.c_int64 * n)(*chain), n,
        _as_u8p(out), cap,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out, cap, [int(v) for v in status]


def _jpeg_segment(ldir: LibtiffDir, i: int) -> tuple:
    """JPEGPreDecode's segment of chunk i: (width, height, the last strip
    of the image), planes past the first scaled by the subsampling."""
    per_plane = _per_plane(ldir)
    if ldir.tiled:
        w, h, row = ldir.tilewidth, ldir.tilelength, 0
    else:
        row = (i % per_plane) * ldir.tilelength
        w, h = ldir.width, min(ldir.length - row, ldir.tilelength)
    if ldir.planar == 2 and i // per_plane > 0:
        hs, vs = ldir.subsampling if ldir.photometric == 6 else (1, 1)
        if not hs or not vs:
            return 0, 0, 0                # sampling zero: refused
        w, h = _howmany(w, hs), _howmany(h, vs)
    return min(w, _INT_MAX), min(h, _INT_MAX), \
        int(not ldir.tiled and row + h == ldir.length)


_YCBCR_SUBSAMPLINGS = ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2),
                       (1, 1))
# the decoded chunks _load_rgba holds at once (libtiff holds one buffer;
# a file past this is refused rather than reproduced)
_MAX_BUFFERS = 1 << 30


def _load_rgba(data: bytes, header: Header, ldir: LibtiffDir,
               predictor: int) -> np.ndarray:
    """YCbCr as Pillow's _decodeAsRGBA reads it: TIFFRGBAImageOK and
    Begin's refusals, then TIFFRGBAImageGet of
    each block of rows (a strip or a row of tiles) at its row_offset, as
    gtStripContig, gtTileContig, gtStripSeparate and gtTileSeparate read
    the chunks (a fresh zeroed buffer each call, reused across a row of
    tiles; a chunk after the first that fails keeps what the codec left)
    and put them (tiff_ycbcr_put, tiff_ycbcr_put_separate); the raster's
    RGBA unpacked with Pillow's rawmode. The rows come out as stored
    whatever the Orientation (Pillow's files under Orientation 2-8 equal
    its Orientation 1 file through exif_transpose alone: no flip of
    setorientation's shows)."""
    from yolov5m_tpu_torch.data.native import _as_u8p, decode_lib

    lib = decode_lib()
    mode, rawmode = header.mode, header.rawmode
    xsize, ysize = header.tile_size
    if rawmode_bits(mode, rawmode) > 32:
        # Pillow's unpacker reads past the raster's row, the last row past
        # its buffer: not reproduced, refused
        raise ValueError("an unpacker wider than the raster row")
    if ldir.bps not in (1, 2, 4, 8, 16) or ldir.sampleformat == 3:
        raise ValueError("TIFFRGBAImageOK refuses the samples")
    if ldir.bps != 8 or ldir.spp != 3:
        raise ValueError("Sorry, can not handle image")
    tabs = np.zeros(1280, np.int32)
    luma = np.array(ldir.coefficients, np.float32)
    refbw = np.array((0, 255, 128, 255, 128, 255) if ldir.refbw is None
                     else ldir.refbw, np.float32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    fp = ctypes.POINTER(ctypes.c_float)
    if lib.tiff_ycbcr_tables(luma.ctypes.data_as(fp), refbw.ctypes.data_as(
            fp), tabs.ctypes.data_as(i32p)):
        raise ValueError("Invalid values for YCbCr conversion")
    contig = ldir.planar == 1
    hs, vs = ldir.subsampling
    if (hs, vs) not in (_YCBCR_SUBSAMPLINGS if contig else ((1, 1),)):
        raise ValueError("Sorry, can not handle image")
    if ldir.tiled:
        rpb = ldir.tilelength
    else:
        rpb = 2 ** 32 - 1 if ldir.rowsperstrip is None else ldir.rowsperstrip
    if rpb == 2 ** 32 - 1:
        rpb = ysize
    w = xsize
    if _INT_MAX // 4 < w or _INT_MAX // (w * 4) < rpb:
        raise ValueError("decoder error -9")
    planes = 1 if contig else 3
    if ldir.tiled:
        size = _chunk_size(ldir)                     # TIFFTileSize
        tw, th = ldir.tilewidth, ldir.tilelength
        if not size or not tw or not th or tw > _INT_MAX + w:
            raise ValueError("unsupported tile size")
    else:
        size = _chunk_size(ldir)                     # TIFFStripSize
        scanline = _scanline(ldir)
        rps = 2 ** 32 - 1 if ldir.rowsperstrip is None else ldir.rowsperstrip
        if not size:
            raise ValueError("decoder error -2")
    # the reads and puts of every TIFFRGBAImageGet, in libtiff's order
    reads, gets = [], []      # reads: (chunk, occ, chain from, first)
    per_plane = _per_plane(ldir)
    for y0 in range(0, ysize, rpb):
        h = min(rpb, ysize - y0)
        puts = []                  # (raster index, w, rows, from, to, reads)
        y = 0
        last = [-1] * planes       # the read each buffer section holds
        row = 0
        if ldir.tiled:
            toskew = -(tw - w)
            while row < h:
                nrow = min(th - (row + y0) % th, h - row)
                tocol, fromskew, this_tw, this_toskew = 0, 0, tw, toskew
                while tocol < w:
                    at = []
                    for p in range(planes):
                        chunk = tile_index(ldir, tocol, row + y0, p)
                        first = last[0] < 0 and p == 0
                        reads.append((chunk, size, last[p], first))
                        last[p] = len(reads) - 1
                        at.append(last[p])
                    pos = ((row + y0) % th) * _tile_row(ldir)
                    if tocol + this_tw > w:
                        fromskew = tw - (w - tocol)
                        this_tw = tw - fromskew
                        this_toskew = toskew + fromskew
                    puts.append((y * w + tocol, this_tw, nrow, fromskew,
                                 this_toskew, at, pos))
                    tocol += this_tw
                    fromskew, this_tw, this_toskew = 0, tw, toskew
                y += nrow
                row += nrow
        else:
            toskew = 0
            while row < h:
                nrow = min(rps - (row + y0) % rps, h - row)
                nrowsub = nrow + (-nrow % vs) if contig else nrow
                temp = (row + y0) % rps + nrowsub
                at = []
                for p in range(planes):
                    chunk = (row + y0) // rps + p * per_plane
                    first = last[0] < 0 and p == 0
                    reads.append((chunk, min(temp * scanline,
                                             _occ(ldir, chunk, False)),
                                  last[p], first))
                    last[p] = len(reads) - 1
                    at.append(last[p])
                pos = ((row + y0) % rps) * scanline
                puts.append((y * w, w, nrow, 0, toskew, at, pos))
                y += nrow
                row += nrow
        gets.append((y0, h, puts))
    if len(reads) * max(size, 1) > _MAX_BUFFERS:
        raise ValueError("chunk buffers past the port's limit")
    if ldir.compression == 6:
        # the old-style codec reads the file itself: a first read whose
        # OJPEGPreDecode fails fails the Get
        slots, cap, status = _decode_ojpeg(
            data, ldir, [r[0] for r in reads], [r[1] for r in reads],
            [r[2] for r in reads])
        for k, (chunk, occ, prev, first) in enumerate(reads):
            if first and status[k] == 2:
                raise ValueError("TIFFRGBAImageGet failed")
        return _put_ycbcr(header, ldir, tabs, gets, slots, cap, size)
    # every read's chunk decoded in turn, failures kept (every chunk
    # index is below the strile arrays' length, padded to it)
    fills = [_fill(ldir, data, chunk, size) for chunk, *_ in reads]
    for k, (chunk, occ, prev, first) in enumerate(reads):
        if first and fills[k] is None:    # no buffer: the Get fails
            raise ValueError("TIFFRGBAImageGet failed")
        # _TIFFReadEncodedTileAndAllocBuffer: a compressed tile over 1000
        # times its bytes, its buffer over 1e8 bytes, is refused
        if first and ldir.tiled and size * planes > 100 * 1000 * 1000 and \
                fills[k][1] < size // 1000:
            raise ValueError("Likely invalid tile byte count")
    slots, cap, status = _decode(
        data, ldir, [r[0] for r in reads], fills, [r[1] for r in reads],
        predictor, [r[2] for r in reads], False)
    for k, (chunk, occ, prev, first) in enumerate(reads):
        if first and ldir.compression == 7 and status[k] == 1:
            raise ValueError("TIFFRGBAImageGet failed")   # JPEGPreDecode
    return _put_ycbcr(header, ldir, tabs, gets, slots, cap, size)


def _put_ycbcr(header: Header, ldir: LibtiffDir, tabs: np.ndarray, gets,
               slots: np.ndarray, cap: int, size: int) -> np.ndarray:
    """_load_rgba's puts: each TIFFRGBAImageGet's raster from the decoded
    chunks (slots, cap bytes apart), unpacked with Pillow's rawmode."""
    from yolov5m_tpu_torch.data.native import _as_u8p, decode_lib

    lib = decode_lib()
    mode, rawmode = header.mode, header.rawmode
    xsize, ysize = header.tile_size
    w = xsize
    contig = ldir.planar == 1
    hs, vs = ldir.subsampling
    i32p = ctypes.POINTER(ctypes.c_int32)
    reads_n = len(slots) // max(cap, 1)
    cap_needed = size
    if cap < cap_needed:
        grown = np.zeros(reads_n * cap_needed, np.uint8)
        for k in range(reads_n):
            grown[k * cap_needed:k * cap_needed + cap] = \
                slots[k * cap:(k + 1) * cap]
        slots, cap = grown, cap_needed
    store = _new(mode, xsize, ysize)
    tp = tabs.ctypes.data_as(i32p)
    for y0, h, puts in gets:
        raster = np.zeros((h, w, 4), np.uint8)
        for start, pw, nrow, fromskew, toskew, at, pos in puts:
            views = [slots[k * cap + pos:(k + 1) * cap] for k in at]
            nin = len(views[0])
            if contig:
                rc = lib.tiff_ycbcr_put(tp, _as_u8p(raster), h * w, start, pw,
                                        nrow, fromskew, toskew,
                                        _as_u8p(views[0]), nin, hs, vs)
            else:
                rc = lib.tiff_ycbcr_put_separate(
                    tp, _as_u8p(raster), h * w, start, pw, nrow, fromskew,
                    toskew, _as_u8p(views[0]), _as_u8p(views[1]),
                    _as_u8p(views[2]), nin)
            if rc:
                raise ValueError("a putter past its buffers")
        unpack(mode, rawmode, np.ascontiguousarray(raster).reshape(h, w * 4),
               xsize, store[y0:y0 + h])
    return store


def tile_index(ldir: LibtiffDir, x: int, y: int, plane: int) -> int:
    """TIFFComputeTile."""
    across = _howmany(ldir.width, ldir.tilewidth)
    down = _howmany(ldir.length, ldir.tilelength)
    return across * (y // ldir.tilelength) + x // ldir.tilewidth + \
        plane * across * down


def _unpack_band(mode: str, plane: int, bps: int, rows: np.ndarray,
                 width: int, store: np.ndarray) -> None:
    """Pillow's planar unpackers ("R", "G", "B", "A" of RGBA, ";16N" at 16
    bits): plane p to byte p of a 4-byte pixel, whatever the mode."""
    if bps == 16:
        v = rows[:, :width * 2].reshape(rows.shape[0], width, 2)
        v = v[..., 1 if sys.byteorder == "little" else 0]
    else:
        v = rows[:, :width]
    store[..., plane] = v


def _inflate(data: bytes, offsets, counts, occs, reverse: bool):
    """libtiff's ZIPDecode of each chunk with Python's zlib: the chunk's
    bytes, or where the stream is bad or ends short what it inflated
    before the fault, the rest zero as ZIPDecode leaves it, marked 1 in
    the fourth result."""
    parts, at, new_offsets, bad = [], 0, [], []
    for off, cnt, occ in zip(offsets, counts, occs):
        raw = data[off:off + cnt]
        if reverse:
            raw = raw.translate(_REVERSE)
        d = zlib.decompressobj()
        failed = False
        try:
            got = d.decompress(raw, occ)
        except zlib.error:
            got, failed = _inflate_prefix(raw, occ), True
        bad.append(int(failed or len(got) < occ))
        got = got + bytes(occ - len(got))
        parts.append(got)
        new_offsets.append(at)
        at += len(got)
    return b"".join(parts), new_offsets, [len(p) for p in parts], bad


def _inflate_prefix(raw: bytes, occ: int) -> bytes:
    """What zlib inflates of raw before the fault (fed a byte at a time,
    so that the output of the bytes before it is kept)."""
    d = zlib.decompressobj()
    got = bytearray()
    for i in range(len(raw)):
        try:
            got += d.decompress(raw[i:i + 1], occ - len(got))
        except zlib.error:
            break
        if len(got) >= occ:
            break
    return bytes(got[:occ])


_REVERSE = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))

TRANSPOSE = {2: "flip_lr", 3: "rot180", 4: "flip_tb", 5: "transpose",
             6: "rot270", 7: "transverse", 8: "rot90"}


def _transpose(img: np.ndarray, method: str) -> np.ndarray:
    """Pillow's Image.Transpose on (h, w, ...) pixels."""
    if method == "flip_lr":
        return img[:, ::-1]
    if method == "flip_tb":
        return img[::-1]
    if method == "rot180":
        return img[::-1, ::-1]
    if method == "transpose":
        return img.swapaxes(0, 1)
    if method == "transverse":
        return img[::-1, ::-1].swapaxes(0, 1)
    if method == "rot90":                    # counter-clockwise
        return img.swapaxes(0, 1)[::-1]
    return img.swapaxes(0, 1)[:, ::-1]       # rot270


def decode(data: bytes, by_path: bool = False,
           header: Optional[Header] = None) -> np.ndarray:
    """(h, w, 3) uint8: Pillow's ``Image.open(...).convert("RGB")`` of a
    TIFF this module decodes (``route`` not None), with Orientation 2-8
    applied as ``exif_transpose`` applies it. by_path: opened by its path
    (Pillow maps a single-strip file). Raises NotTiff where Pillow's
    plugin passes the file on, ValueError where Pillow refuses it."""
    data = bytes(data)
    header = header or open_tiff(data)
    kind = route(header, data)
    if kind is None:
        raise ValueError("a TIFF this module leaves to other decoders")
    try:
        store = _load_raw(data, header, by_path) if kind == "raw" else \
            _load_libtiff(data, header)
    except (TypeError, OverflowError) as e:   # a value Pillow's load chokes on
        raise ValueError(str(e)) from e
    except MemoryError as e:
        raise ValueError("out of memory") from e
    palette = header.palette
    if palette is not None and len(palette) > 768:
        raise ValueError("wrong palette size")
    rgb = convert.to_rgb(header.mode, store, palette)
    method = TRANSPOSE.get(header.orientation) \
        if _hashable(header.orientation) else None
    if method is not None:
        rgb = np.ascontiguousarray(_transpose(rgb, method))
    return rgb


def _hashable(value) -> bool:
    try:
        hash(value)
        return True
    except TypeError:
        return False
