"""Pillow 12.1.0's open order, for the port's router (data/native.py).

``Image.open`` reads a 16-byte prefix and tries its plugins in the order
they registered: ``preinit()``'s six (BMP, DIB, GIF, JPEG, PPM, PNG), then,
where none opened the file, ``init()``'s others. A plugin whose accept
function takes the prefix (or that has none: IM, IMT, IPTC, PCD, SPIDER
and TGA) runs its ``_open``; SyntaxError, IndexError, TypeError,
struct.error (and KeyError or EOFError, which ``ImageFile`` turns into
SyntaxError), or a size below 1, pass the file to the next plugin; any
other error ends the open. ``PLUGINS`` is that list, each plugin with its
accept function and how the port opens it:

- ``"signature"``: a plugin the port read before this table (PNG, JPEG,
  BMP, GIF, WebP, PPM, TIFF, JPEG 2000): its accept routes the file to
  the port's decoder; the PPM, TIFF and JPEG 2000 plugins, which pass
  some files on, first run the port's copy of their open (``OPENS``);
- ``"raster"``: data/raster.py's copy of the plugin's open;
- a function of the bytes for a plugin the port leaves to PIL: True where
  that plugin's ``_open`` gets past the header checks that raise
  SyntaxError (it opens the file, or fails it outright), so the file goes
  to ``_decode_other`` by its header alone; False where it would pass the
  file on, so the walk goes on. A plugin after the last one the port
  reads needs no checks (XPM, XVTHUMB): nothing the port reads follows.

``pick`` returns the plugin that finally takes the file, with the port's
open of it (or the ValueError that open raised): a file that no plugin
takes is refused, as ``Image.open`` refuses it.
"""

from __future__ import annotations

import functools
import io
import re
import struct
from typing import Callable, NamedTuple, Optional, Union

from yolov5m_tpu_torch.data import jpeg2k, pnm, raster, tiff
from yolov5m_tpu_torch.data.raster import _i16be, _i16le, _i32be, _i32le


# -- accept functions (the plugins' own) --------------------------------------

def _avif(p):
    return p[4:8] == b"ftyp" and p[8:12] in (b"avif", b"avis", b"mif1",
                                             b"msf1")


def _fli(p):
    return len(p) >= 16 and _i16le(p, 4) in (0xAF11, 0xAF12) and \
        _i16le(p, 14) in (0, 3)


def _gbr(p):
    return len(p) >= 8 and _i32be(p, 0) >= 20 and _i32be(p, 4) in (1, 2)


def _eps(p):
    return p.startswith(b"%!PS") or (len(p) >= 4 and
                                     _i32le(p) == 0xC6D3D0C5)


def _gif(p):
    return p[:6] in (b"GIF87a", b"GIF89a")


def _webp(p):
    return p[:4] == b"RIFF" and p[8:12] == b"WEBP" and \
        p[12:16] in (b"VP8 ", b"VP8L", b"VP8X")


# -- header checks of the plugins the port leaves to PIL ----------------------

def _fli_opens(data: bytes) -> bool:
    s = data[:128]
    return s[20:22] == b"\x00" * 2 and s[42:80] == b"\x00" * 38 and \
        s[88:] == b"\x00" * 40


def _gbr_opens(data: bytes) -> bool:
    fp = io.BytesIO(data)
    try:
        header_size = _i32be(fp.read(4))
        version = _i32be(fp.read(4))
        width, height = _i32be(fp.read(4)), _i32be(fp.read(4))
        depth = _i32be(fp.read(4))
        if header_size < 20 or version not in (1, 2) or width == 0 or \
                height == 0 or depth not in (1, 4):
            return False
        if version == 2 and fp.read(4) != b"GIMP":
            return False
        if version == 2:
            _i32be(fp.read(4))
    except struct.error:
        return False
    return True


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _imt_opens(data: bytes) -> bool:
    """ImtImagePlugin's _open: True where it leaves a mode and a size above
    0 (or fails on a bad number)."""
    fp = io.BytesIO(data)
    buffer = fp.read(100)
    if b"\n" not in buffer:
        return False
    xsize = ysize = 0
    mode = ""
    try:
        while True:
            if buffer:
                s, buffer = buffer[:1], buffer[1:]
            else:
                s = fp.read(1)
            if not s or s == b"\x0c":
                break
            if b"\n" not in buffer:
                buffer += fp.read(100)
            lines = buffer.split(b"\n")
            s += lines.pop(0)
            buffer = b"\n".join(lines)
            if len(s) == 1 or len(s) > 100:
                break
            if s[0] == ord(b"*"):
                continue
            m = _IMT_FIELD.match(s)
            if not m:
                break
            k, v = m.group(1, 2)
            if k == b"width":
                xsize = int(v)
            elif k == b"height":
                ysize = int(v)
            elif k == b"pixel" and v == b"n8":
                mode = "L"
    except ValueError:
        return True
    return bool(mode) and xsize > 0 and ysize > 0


def _iptc_opens(data: bytes) -> bool:
    """IptcImagePlugin's _open: its fields, then the (3, 60) and size
    tags; True where it gets a mode and a size above 0 (or fails with
    OSError)."""
    fp = io.BytesIO(data)
    info = {}

    def field():
        s = fp.read(5)
        if not s.strip(b"\x00"):
            return None, 0
        tag = s[1], s[2]
        if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            raise SyntaxError("invalid IPTC/NAA file")
        size = s[3]
        if size > 132:
            raise OSError("illegal field length in IPTC/NAA file")
        if size == 128:
            size = 0
        elif size > 128:
            size = _i32be((b"\0\0\0\0" + fp.read(size - 128))[-4:])
        else:
            size = _i16be(s, 3)
        return tag, size

    try:
        while True:
            tag, size = field()
            if not tag or tag == (8, 10):
                break
            info[tag] = fp.read(size) if size else None
        layers, component = info[(3, 60)][0], info[(3, 60)][1]
        mode = ""
        if layers == 1 and not component:
            mode = "L"
        elif layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        w = _i32be((b"\0\0\0\0" + info[(3, 20)])[-4:])
        h = _i32be((b"\0\0\0\0" + info[(3, 30)])[-4:])
        _i32be((b"\0\0\0\0" + info[(3, 120)])[-4:])
    except (SyntaxError, IndexError, TypeError, KeyError, struct.error):
        return False
    except OSError:
        return True
    return bool(mode) and w > 0 and h > 0


def _mcidas_opens(data: bytes) -> bool:
    s = data[:256]
    if len(s) != 256:
        return False
    w = struct.unpack("!64i", s)
    return w[10] in (1, 2, 4) and w[9] > 0 and w[8] > 0


def _pcd_opens(data: bytes) -> bool:
    return data[2048:2052] == b"PCD_" and len(data) >= 2048 + 1539


def _pixar_opens(data: bytes) -> bool:
    s = data[:512]
    try:
        size = _i16le(s, 418), _i16le(s, 416)
        mode = _i16le(s, 424), _i16le(s, 426)
    except struct.error:
        return False
    return mode == (14, 2) and size[0] > 0 and size[1] > 0


def _psd_opens(data: bytes) -> bool:
    try:
        return _i16be(data[:26], 4) == 1
    except struct.error:
        return False


def _sun_opens(data: bytes) -> bool:
    s = data[:32]
    try:
        w, h, depth = _i32be(s, 4), _i32be(s, 8), _i32be(s, 12)
        file_type, palette_type = _i32be(s, 20), _i32be(s, 24)
        palette_length = _i32be(s, 28)
    except struct.error:
        return False
    if depth not in (1, 4, 8, 24, 32):
        return False
    if palette_length and (palette_length > 1024 or palette_type != 1):
        return False
    return file_type in (0, 1, 2, 3, 4, 5) and w > 0 and h > 0


def _wmf_opens(data: bytes) -> bool:
    s = data[:44]
    if s.startswith(b"\xd7\xcd\xc6\x9a\x00\x00"):
        try:
            inch = _i16le(s, 14)
        except struct.error:
            return False
        return inch == 0 or s[22:26] == b"\x01\x00\t\x00"
    return s.startswith(b"\x01\x00\x00\x00") and s[40:44] == b" EMF"


def _always(data: bytes) -> bool:
    return True


class Plugin(NamedTuple):
    name: str
    accept: Optional[Callable]
    opens: Union[str, Callable]


PLUGINS = (
    Plugin("BMP", lambda p: p[:2] == b"BM", "signature"),
    Plugin("DIB", raster.dib_accepts, "raster"),
    Plugin("GIF", _gif, "signature"),
    Plugin("JPEG", lambda p: p[:3] == b"\xff\xd8\xff", "signature"),
    Plugin("PPM", pnm.accepts, "signature"),
    Plugin("PNG", lambda p: p[:8] == b"\x89PNG\r\n\x1a\n", "signature"),
    Plugin("AVIF", _avif, _always),
    Plugin("BLP", lambda p: p[:4] in (b"BLP1", b"BLP2"), _always),
    Plugin("BUFR", lambda p: p[:4] in (b"BUFR", b"ZCZC"), _always),
    Plugin("CUR", raster.cur_accepts, "raster"),
    Plugin("PCX", raster.pcx_accepts, "raster"),
    Plugin("DCX", raster.dcx_accepts, "raster"),
    Plugin("DDS", lambda p: p[:4] == b"DDS ", _always),
    Plugin("EPS", _eps, _always),
    Plugin("FITS", lambda p: p[:6] == b"SIMPLE", _always),
    Plugin("FLI", _fli, _fli_opens),
    Plugin("FTEX", lambda p: p[:4] == b"FTEX", _always),
    Plugin("GBR", _gbr, _gbr_opens),
    Plugin("GRIB", lambda p: len(p) >= 8 and p[:4] == b"GRIB" and p[7] == 1,
           _always),
    Plugin("HDF5", lambda p: p[:8] == b"\x89HDF\r\n\x1a\n", _always),
    Plugin("JPEG2000", jpeg2k.accepts, "signature"),
    Plugin("ICNS", lambda p: p[:4] == b"icns", _always),
    Plugin("ICO", raster.ico_accepts, "raster"),
    Plugin("IM", None, "raster"),
    Plugin("IMT", None, _imt_opens),
    Plugin("IPTC", None, _iptc_opens),
    Plugin("MCIDAS", lambda p: p[:8] == b"\x00" * 7 + b"\x04",
           _mcidas_opens),
    Plugin("MPEG", lambda p: p[:4] == b"\x00\x00\x01\xb3", _always),
    Plugin("TIFF", tiff.accepts, "signature"),
    Plugin("MSP", raster.msp_accepts, "raster"),
    Plugin("PCD", None, _pcd_opens),
    Plugin("PIXAR", lambda p: p[:4] == b"\200\350\000\000", _pixar_opens),
    Plugin("PSD", lambda p: p[:4] == b"8BPS", _psd_opens),
    Plugin("QOI", raster.qoi_accepts, "raster"),
    Plugin("SGI", raster.sgi_accepts, "raster"),
    Plugin("SPIDER", None, "raster"),
    Plugin("SUN", lambda p: len(p) >= 4 and _i32be(p) == 0x59A66A95,
           _sun_opens),
    Plugin("TGA", None, "raster"),
    Plugin("WEBP", _webp, "signature"),
    Plugin("WMF", lambda p: p[:6] == b"\xd7\xcd\xc6\x9a\x00\x00" or
           p[:4] == b"\x01\x00\x00\x00", _wmf_opens),
    Plugin("XBM", raster.xbm_accepts, "raster"),
    Plugin("XPM", lambda p: p[:9] == b"/* XPM */", _always),
    Plugin("XVTHUMB", lambda p: p[:6] == b"P7 332", _always),
)
# the port's decoder of each plugin read before this table
SIGNATURE_FORMATS = {"BMP": "bmp", "GIF": "gif", "JPEG": "jpeg",
                     "PPM": "pnm", "PNG": "png", "JPEG2000": "jpeg2k",
                     "TIFF": "tiff", "WEBP": "webp"}
# the port's open of each signature plugin that passes files on: it returns
# the header, raises the exception named where the plugin passes the file
# on and ValueError where the open fails
OPENS = {"PPM": (pnm.read_header, pnm.NotPnm),
         "TIFF": (tiff.open_tiff, tiff.NotTiff),
         "JPEG2000": (jpeg2k.open_j2k, jpeg2k.NotJpeg2k)}


class Picked(NamedTuple):
    name: str                # Pillow's format name
    # the port's open: a raster.Opened, or the pnm, tiff or jpeg2k Header
    opened: object
    refused: bool = False    # that open failed outright


def _accepts(plugin: Plugin, prefix: bytes) -> bool:
    """Whether _open_core tries the plugin: no accept function, or one
    that takes the prefix (an IndexError or struct.error out of it passes
    the file on)."""
    if plugin.accept is None:
        return True
    try:
        return bool(plugin.accept(prefix))
    except (IndexError, struct.error):
        return False


def pick(data, by_path: bool = False,
         prefix: bool = False) -> Optional[Picked]:
    """The plugin Pillow's ``Image.open`` picks for data, or None where no
    plugin takes it. by_path: Pillow opens the file by its path. prefix:
    data is only the file's first bytes, so a signature plugin is picked
    by its accept alone (its open may need the rest)."""
    data = bytes(data)
    for plugin in PLUGINS:
        if not _accepts(plugin, data[:16]):
            continue
        if plugin.opens == "signature":
            if plugin.name not in OPENS or prefix:
                return Picked(plugin.name, None)
            port_open, passed_on = OPENS[plugin.name]
        elif plugin.opens == "raster":
            port_open = functools.partial(raster.open_format, plugin.name,
                                          by_path=by_path)
            passed_on = raster.PassOn
        elif plugin.opens(data):
            return Picked(plugin.name, None)
        else:
            continue
        try:
            return Picked(plugin.name, port_open(data))
        except passed_on:
            continue
        except ValueError:
            return Picked(plugin.name, None, True)
    return None
