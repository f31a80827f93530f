"""DDS, BLP and FTEX as Pillow 12.1.0's plugins read them, then
``convert("RGB")``.

The JAX package hands these files to Pillow (the server's and the
loader's ``_decode_image``, detect ``--img``'s ``Image.open``, the
dataset's ``_read_image_size``). This module is the port's copy of the
three plugins' opens (the same reads over the file's bytes, so that a
short read fails as it fails there) and loads:

- DDS (``DdsImagePlugin``): RGB masks through its Python ``dds_rgb``
  decoder, L, LA, P (an RGBA palette) and R8G8B8A8 as raw tiles, the FourCC
  and DX10 block formats through Pillow's C ``"bcn"`` decoder (BC1-BC7,
  BC5 and BC6H signed too). The tiles' offsets are never sought
  (``load_seek`` does nothing): pixels start where the open left the
  file.
- FTEX (``FtexImagePlugin``): the one mipmap the open reads, DXT1 through
  ``"bcn"`` or raw RGB.
- BLP (``BlpImagePlugin``): BLP1 and BLP2 palettes, BLP1's JPEG (the
  port's Pillow JPEG decoder, its RGB set as BGR), BLP2's DXT1, DXT3 and
  DXT5 through the plugin's own Python decoders, which differ from
  ``"bcn"`` (5:6:5 colours without their low bits copied; each block
  row's pixel rows the padded width long, read as one stream; DXT3 and
  DXT5 always four bytes a pixel, read three a pixel where the file has
  no alpha).

The byte loops are ``csrc/bcn_decode.cc``. Each open is entered through
``raster.open_format`` (formats.OPENERS_RASTER), which applies
``Image.open``'s pass-on rules; each load through ``raster.decode``.
"""

from __future__ import annotations

import ctypes
import io
import os
import struct

import numpy as np

from yolov5m_tpu_torch.data import convert, raster
from yolov5m_tpu_torch.data.raster import Opened

# DDPF flags
_ALPHAPIXELS, _FOURCC, _PALETTEINDEXED8 = 0x1, 0x4, 0x20
_RGB, _LUMINANCE = 0x40, 0x20000
# FourCC -> (mode, the "bcn" decoder's n, signed)
_FOURCCS = {b"DXT1": ("RGBA", 1, 0), b"DXT3": ("RGBA", 2, 0),
            b"DXT5": ("RGBA", 3, 0), b"BC4U": ("L", 4, 0),
            b"ATI1": ("L", 4, 0), b"BC5S": ("RGB", 5, 1),
            b"BC5U": ("RGB", 5, 0), b"ATI2": ("RGB", 5, 0)}
# DX10's DXGI formats Pillow reads: the block formats, n 0 for R8G8B8A8
_DXGI = {70: ("RGBA", 1, 0), 71: ("RGBA", 1, 0), 73: ("RGBA", 2, 0),
         74: ("RGBA", 2, 0), 76: ("RGBA", 3, 0), 77: ("RGBA", 3, 0),
         79: ("L", 4, 0), 80: ("L", 4, 0), 82: ("RGB", 5, 0),
         83: ("RGB", 5, 0), 84: ("RGB", 5, 1), 95: ("RGB", 6, 0),
         96: ("RGB", 6, 1), 97: ("RGBA", 7, 0), 98: ("RGBA", 7, 0),
         99: ("RGBA", 7, 0), 27: ("RGBA", 0, 0), 28: ("RGBA", 0, 0),
         29: ("RGBA", 0, 0)}


def dds_accepts(prefix: bytes) -> bool:
    return prefix.startswith(b"DDS ")


def blp_accepts(prefix: bytes) -> bool:
    return prefix.startswith((b"BLP1", b"BLP2"))


def ftex_accepts(prefix: bytes) -> bool:
    return prefix.startswith(b"FTEX")


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def bcn_pixels(data: bytes, offset: int, size, n: int, sign: int = 0,
               channels: int = 4) -> np.ndarray:
    """(h, w, channels) of Pillow's "bcn" decoder n over the blocks from
    offset: the first channels of RGBA (BC4's grey the first); ValueError
    where the blocks run out."""
    w, h = size
    if len(data) - offset < _blocks(size, 8 if n in (1, 4) else 16):
        raise ValueError("image file is truncated")
    out = np.empty((h, w, channels), np.uint8)
    buf = raster._buf(data)[offset:]
    raster._lib().bcn_decode(_u8(buf), buf.size, w, h, n, sign, channels,
                             _u8(out))
    return out


def _blocks(size, block: int) -> int:
    """Bytes of the 4x4 blocks that cover an image of size (w, h)."""
    return ((size[0] + 3) // 4) * ((size[1] + 3) // 4) * block


def _bcn_rgb(data: bytes, offset: int, size, n: int, sign: int,
             mode: str) -> np.ndarray:
    """convert("RGB") of a "bcn" tile of mode L, RGB or RGBA."""
    if mode == "L":
        return convert.to_rgb("L", bcn_pixels(data, offset, size, n, sign,
                                               1))
    return bcn_pixels(data, offset, size, n, sign, 3)


def _raw(data: bytes, offset: int, size, mode: str) -> np.ndarray:
    """A raw tile of mode (rawmode the mode: L, LA, P, RGB or RGBA) from
    offset; ValueError where the file holds too few bytes."""
    k = len(mode)
    rows = raster.raw_rows(data, offset, size, 8 * k)
    return rows[:, :size[0] * k].reshape(size[1], size[0], k)


# -- DDS (DdsImagePlugin) -----------------------------------------------------

def _dds_rgb(data: bytes, offset: int, size, bitcount: int,
             masks) -> np.ndarray:
    w, h = size
    out = np.zeros((h, w, 4), np.uint8)
    buf = raster._buf(data)[offset:]
    m = np.array(list(masks) + [0] * (4 - len(masks)), np.uint32)
    raster._lib().dds_rgb(_u8(buf), buf.size, w, h, bitcount // 8,
                          m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                          len(masks), _u8(out))
    return np.ascontiguousarray(out[..., :3])


def _open_dds(fp) -> Opened:
    if not dds_accepts(fp.read(4)):
        raise SyntaxError("not a DDS file")
    header_size, = struct.unpack("<I", fp.read(4))
    if header_size != 124:
        raise OSError(f"Unsupported header size {header_size!r}")
    header = fp.read(header_size - 4)
    if len(header) != 120:
        raise OSError(f"Incomplete header: {len(header)} bytes")
    _, height, width = struct.unpack("<3I", header[:12])
    size = (width, height)
    _, pfflags, fourcc, bitcount = struct.unpack("<4I", header[68:84])
    fourcc = struct.pack("<I", fourcc)
    if pfflags & _RGB:
        mode = "RGBA" if pfflags & _ALPHAPIXELS else "RGB"
        masks = struct.unpack(f"<{len(mode)}I",
                              header[84:84 + 4 * len(mode)])
        offset = fp.tell()
        return Opened("DDS", mode, size, lambda data, by_path: _dds_rgb(
            data, offset, size, bitcount, masks))
    palette = None
    n = sign = 0
    if pfflags & _LUMINANCE:
        if bitcount == 8:
            mode = "L"
        elif bitcount == 16 and pfflags & _ALPHAPIXELS:
            mode = "LA"
        else:
            raise OSError(f"Unsupported bitcount {bitcount} for {pfflags}")
    elif pfflags & _PALETTEINDEXED8:
        mode = "P"
        rgba = fp.read(1024)
        palette = np.frombuffer(rgba[:len(rgba) // 4 * 4], np.uint8).reshape(
            -1, 4)[:, :3].T.tobytes()
    elif pfflags & _FOURCC:
        if fourcc in _FOURCCS:
            mode, n, sign = _FOURCCS[fourcc]
        elif fourcc == b"DX10":
            dxgi, = struct.unpack("<I", fp.read(4))
            fp.read(16)
            if dxgi not in _DXGI:
                raise NotImplementedError(f"Unimplemented DXGI format {dxgi}")
            mode, n, sign = _DXGI[dxgi]
        else:
            raise NotImplementedError(
                f"Unimplemented pixel format {fourcc!r}")
    else:
        raise NotImplementedError(f"Unknown pixel format flags {pfflags}")
    offset = fp.tell()

    def load(data, by_path):
        if n:
            return _bcn_rgb(data, offset, size, n, sign, mode)
        return convert.to_rgb(mode, _raw(data, offset, size, mode), palette)

    return Opened("DDS", mode, size, load)


# -- FTEX (FtexImagePlugin) ---------------------------------------------------

def _open_ftex(fp) -> Opened:
    if not ftex_accepts(fp.read(4)):
        raise SyntaxError("not an FTEX file")
    struct.unpack("<i", fp.read(4))                       # version
    size = struct.unpack("<2i", fp.read(8))
    _, format_count = struct.unpack("<2i", fp.read(8))
    if format_count != 1:            # the plugin's assert: the open fails
        raise AssertionError("format_count != 1")
    fmt, where = struct.unpack("<2i", fp.read(8))
    fp.seek(where)
    mipmap_size, = struct.unpack("<i", fp.read(4))
    mipmap = fp.read(mipmap_size)
    if fmt == 0:
        mode = "RGBA"
    elif fmt == 1:
        mode = "RGB"
    else:
        raise ValueError(f"Invalid texture compression format: {fmt!r}")

    def load(data, by_path):
        if fmt == 0:
            return _bcn_rgb(mipmap, 0, size, 1, 0, mode)
        return _raw(mipmap, 0, size, "RGB")

    return Opened("FTEX", mode, size, load)


# -- BLP (BlpImagePlugin) -----------------------------------------------------

def _set_as_raw(stream: bytes, size, mode: str,
                rawmode: str = None) -> np.ndarray:
    """ImageFile.PyDecoder.set_as_raw, then convert("RGB"): the stream's
    first rows of mode's (or rawmode's) pixels; ValueError where it holds
    fewer ("not enough image data")."""
    w, h = size
    rawmode = rawmode or mode
    k = len(rawmode)
    if len(stream) < w * h * k:
        raise ValueError("not enough image data")
    px = np.frombuffer(stream, np.uint8, w * h * k).reshape(h, w, k)
    if rawmode == "BGR":
        px = px[..., ::-1]
    return np.ascontiguousarray(px[..., :3])


def _read_palette(fd) -> bytes:
    """_read_palette: 256 BGRA entries (a short read raises, as
    ImageFile._safe_read does, before the loop's struct.error)."""
    return raster._safe_read(fd, 1024)


def _read_bgra(fd, palette: bytes, length: int, alpha: bool) -> bytes:
    """_read_bgra: each of length index bytes through the palette, as
    RGB or RGBA."""
    idx = np.frombuffer(raster._safe_read(fd, length), np.uint8)
    bgra = np.frombuffer(palette, np.uint8).reshape(256, 4)
    return bgra[:, [2, 1, 0, 3] if alpha else [2, 1, 0]][idx].tobytes()


def _blp_jpeg(fd, offsets, lengths, size, mode: str) -> np.ndarray:
    """BLP1Decoder._decode_jpeg_stream: the shared header joined to the
    first mipmap, opened as a JPEG (Pillow's bomb check), decoded under
    jpegmode "CMYK", its RGB bytes set as BGR."""
    from yolov5m_tpu_torch.data import native

    header_size, = struct.unpack("<I", raster._safe_read(fd, 4))
    header = raster._safe_read(fd, header_size)
    raster._safe_read(fd, offsets[0] - fd.tell())
    jpeg = header + raster._safe_read(fd, lengths[0])
    buf = np.frombuffer(jpeg, np.uint8)
    hw = native.pillow_jpeg_size(buf)
    if hw is None:
        raise ValueError("the BLP's JPEG does not open")
    if hw[0] * hw[1] > raster.MAX_PIXELS:
        raise ValueError("decompression bomb")
    lib = native.decode_lib()
    img = native._decode(lib.jpeg_dims_mode, lib.decode_jpeg_u8_mode, buf, 3)
    if img is None:
        raise ValueError("the BLP's JPEG does not decode")
    return _set_as_raw(img.tobytes(), size, mode, "BGR")


def _blp_dxt(data: bytes, offset: int, size, enc: int,
             alpha: bool) -> bytes:
    """BLP2's DXT stream: decode_dxt1/3/5 over each block row read in
    turn from offset (a row cut short fails the load)."""
    w, h = size
    if len(data) - offset < _blocks(size, 8 if enc == 0 else 16):
        raise OSError("Truncated File Read")
    bpp = 3 if enc == 0 and not alpha else 4
    out = np.zeros(((h + 3) // 4) * 4 * ((w + 3) // 4) * 4 * bpp, np.uint8)
    buf = raster._buf(data)[offset:]
    raster._lib().blp_dxt(_u8(buf), buf.size, w, h, enc, int(alpha),
                          _u8(out))
    return out.tobytes()


def _open_blp(fp) -> Opened:
    magic = fp.read(4)
    if not blp_accepts(magic):
        raise NotImplementedError(f"Bad BLP magic {magic!r}")
    compression, = struct.unpack("<i", fp.read(4))
    if magic == b"BLP1":
        alpha = struct.unpack("<I", fp.read(4))[0] != 0
    else:
        encoding, = struct.unpack("<b", fp.read(1))
        alpha = struct.unpack("<b", fp.read(1))[0] != 0
        alpha_encoding, = struct.unpack("<b", fp.read(1))
        fp.seek(1, os.SEEK_CUR)
    size = struct.unpack("<II", fp.read(8))
    if magic == b"BLP1":
        encoding, = struct.unpack("<i", fp.read(4))
        fp.seek(4, os.SEEK_CUR)
        offset = 28
    else:
        offset = 20
    mode = "RGBA" if alpha else "RGB"

    def load(data, by_path):
        fd = io.BytesIO(data)
        fd.seek(offset)
        offsets = struct.unpack("<16I", raster._safe_read(fd, 64))
        lengths = struct.unpack("<16I", raster._safe_read(fd, 64))
        if magic == b"BLP1":
            if compression == 0:
                return _blp_jpeg(fd, offsets, lengths, size, mode)
            if compression != 1 or encoding not in (4, 5):
                raise NotImplementedError("Unsupported BLP encoding")
            palette = _read_palette(fd)
            return _set_as_raw(_read_bgra(fd, palette, lengths[0], alpha),
                               size, mode)
        palette = _read_palette(fd)
        fd.seek(offsets[0])
        if compression != 1:
            raise NotImplementedError("Unknown BLP compression")
        if encoding == 1:
            stream = _read_bgra(fd, palette, lengths[0], alpha)
        elif encoding == 2 and alpha_encoding in (0, 1, 7):
            stream = _blp_dxt(data, offsets[0], size, alpha_encoding, alpha)
        else:
            raise NotImplementedError("Unknown BLP encoding")
        return _set_as_raw(stream, size, mode)

    return Opened("BLP", mode, size, load)


OPENERS = {"BLP": _open_blp, "DDS": _open_dds, "FTEX": _open_ftex}
