"""The raster corpus (tests/fixtures/torch_raster_corpus/): DIB, ICO, CUR,
PCX, DCX, MSP, QOI, SGI, SPIDER, TGA, XBM and IM files, which the JAX
package hands to Pillow 12.1.0 and the port reads in data/raster.py (its
router in data/formats.py).

Small files made from numpy seeds (file names give the width before the
height; each name starts with its format):

- Pillow's writers, in round trips: DIB (1, L, P, RGB), ICO (PNG entries,
  and DIB entries with their AND masks at 1, 4, 8, 24 and 32 bits), PCX
  (1, L, P, RGB), TGA (L, LA, P, RGB, RGBA, raw and RLE, both
  orientations, an ID field), SGI (L, RGB, RGBA at 8 and 16 bits, raw),
  QOI (RGB, RGBA), MSP (version 1), XBM (with and without a hot spot), IM
  (1, L, LA, P, I, I;16, I;16L, I;16B, F, RGB, RGBA, RGBX, CMYK, YCbCr)
  and SPIDER;
- written here, what the writers never emit: DCX, CUR (the largest of
  several entries, 32 bits), TGA 16-bit pixels, 16-, 24- and 32-bit
  colour maps with a first entry above 0 under each origin flag, type 1
  without a map, RLE packets that run on across rows; PCX 1-bit with 2
  and 4 planes, odd strides, a trailing palette that is a grey ramp; SGI
  RLE at 8 and 16 bits with 1, 3 and 4 channels, rows that stop early or
  overrun; MSP version 2; IM planar RGB (``RGB3``), ``Lut`` palettes
  (grey, linear, coloured), B2 and B4, ``L*5`` bit-packed floats, 8- and
  16-bit float types; SPIDER little- and big-endian, stacks; XBM with
  upper-case hex; QOI with every op;
- cut files, and headers the plugins pass on or refuse.

``digests.json`` holds, for each file, the sha256 of each JAX route's
pixels on this machine, null where it fails, and the (h, w) Pillow's open
reads (tests/torch_tiff_corpus.py:reference), the made scenes' too: the
640x480 scene (tests/torch_jpeg_fixtures.py:scene 0) as TGA RLE, PCX RGB,
SGI RLE, QOI, IM, SPIDER and XBM, and its 256x256 crop as ICO, made by
``made()`` with numpy alone (chip_smoke.py makes them on the card). This
module imports neither Pillow nor another test module until ``write``
runs. Remake the corpus (Pillow and the JAX package needed) with

  python -m tests.torch_raster_corpus [folder]
"""

import hashlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np

FOLDER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                      "torch_raster_corpus")
DIGESTS = "digests.json"
SCENES = ("scene_tga_rle_640x480.tga", "scene_pcx_rgb_640x480.pcx",
          "scene_sgi_rle_640x480.sgi", "scene_qoi_640x480.qoi",
          "scene_im_640x480.im", "scene_spider_640x480.spi",
          "scene_xbm_640x480.xbm", "scene_ico_256x256.ico")
MADE = SCENES
# chip_smoke.py's 9s: no scene under an Orientation (detect --img reads
# the rate scene), and the files a plugin the port does not read opens
ROTATED = None
LEFT_TO_PIL = ("imt_", "pcd_")


def _sibling(name: str):
    """tests/{name}.py by its path (chip_smoke.py loads this module so)."""
    import importlib.util

    if f"tests.{name}" in sys.modules:
        return sys.modules[f"tests.{name}"]
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def picture(seed: int, h: int, w: int, channels: int = 3,
            high: int = 256) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, high, (h, w, channels), np.int64)


def grid(seed: int, shape, high: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, high, shape, np.int64)


def digest(img) -> str:
    return None if img is None else hashlib.sha256(
        np.ascontiguousarray(img).tobytes()).hexdigest()


def pillow_written(arr, fmt: str, mode: str = None, **kw) -> bytes:
    """Bytes from Pillow's own writer of fmt."""
    from PIL import Image

    im = arr if isinstance(arr, Image.Image) else Image.fromarray(arr)
    if mode is not None and im.mode != mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


# -- writers (numpy) ----------------------------------------------------------

def dib(px: np.ndarray, bits: int, palette=None, header: int = 40,
        height_rows: int = None, top_down: bool = False) -> bytes:
    """A DIB: the info header, the palette (BGRX entries), the rows bottom
    up, padded to 4 bytes. px: (h, w) indices or (h, w, 3|4) RGB(A)."""
    h, w = px.shape[:2]
    stride = ((w * bits + 31) >> 3) & ~3
    rows = []
    for y in range(h):
        r = px[y]
        if bits <= 8:
            v = r.astype(np.uint8)
            if bits < 8:
                per = 8 // bits
                pad = (-len(v)) % per
                v = np.concatenate([v, np.zeros(pad, np.uint8)]).reshape(
                    -1, per)
                v = sum(v[:, k].astype(np.int32) << (8 - bits * (k + 1))
                        for k in range(per)).astype(np.uint8)
            raw = v.tobytes()
        elif bits == 24:
            raw = r[:, [2, 1, 0]].astype(np.uint8).tobytes()
        elif bits == 32:
            c = r if r.shape[1] == 4 else np.concatenate(
                [r, np.zeros((w, 1), r.dtype)], 1)
            raw = c[:, [2, 1, 0, 3]].astype(np.uint8).tobytes()
        else:                                   # 16: 5-5-5
            c = r.astype(np.int32) >> 3
            raw = (c[:, 0] << 10 | c[:, 1] << 5 | c[:, 2]).astype(
                "<u2").tobytes()
        rows.append(raw + bytes(stride - len(raw)))
    if not top_down:
        rows = rows[::-1]
    pal = b""
    if palette is not None:
        pal = b"".join(bytes((int(b), int(g), int(r), 0))
                       for r, g, b in palette)
    hh = height_rows if height_rows is not None else h
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, hh, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", 40, w, -hh if top_down else hh,
                           1, bits, 0, stride * h, 2835, 2835,
                           0 if palette is None else len(palette), 0)
    return info + pal + b"".join(rows)


def and_mask(mask: np.ndarray) -> bytes:
    """ICO's AND mask: 1 bit a pixel, rows padded to 32 bits, bottom up."""
    h, w = mask.shape
    wp = (w + 31) // 32 * 32
    m = np.zeros((h, wp), np.uint8)
    m[:, :w] = mask
    return np.packbits(m[::-1], axis=1).tobytes()


def icon_dir(kind: int, entries) -> bytes:
    """An ICO (kind 1) or CUR (kind 2) directory and its payloads: entries
    are (width byte, height byte, colours, bpp or hotspot, payload)."""
    out = struct.pack("<HHH", 0, kind, len(entries))
    offset = 6 + 16 * len(entries)
    body = b""
    for w, h, colors, bpp, payload in entries:
        out += struct.pack("<BBBBHHII", w, h, colors, 0, 1, bpp,
                           len(payload), offset + len(body))
        body += payload
    return out + body


def pcx(rows_planes: np.ndarray, bits: int, version: int = 5,
        palette16=None, stride: int = None, provided: int = None,
        trailing=None, literal: bool = False) -> bytes:
    """A PCX: rows_planes (h, planes, stride bytes) RLE-coded plane by
    plane in each row; the header's stride is provided (or the real)."""
    h, planes, st = rows_planes.shape
    w = stride if stride is not None else st * 8 // bits
    hdr = bytearray(128)
    hdr[0], hdr[1], hdr[2], hdr[3] = 10, version, 1, bits
    struct.pack_into("<HHHH", hdr, 4, 0, 0, w - 1, h - 1)
    struct.pack_into("<HH", hdr, 12, 72, 72)
    if palette16 is not None:
        hdr[16:64] = bytes(np.asarray(palette16, np.uint8).ravel()[:48])
    hdr[65] = planes
    struct.pack_into("<H", hdr, 66, st if provided is None else provided)
    body = bytearray()
    for y in range(h):
        for p in range(planes):
            line = rows_planes[y, p]
            x = 0
            while x < st:
                v = int(line[x])
                n = 1
                while not literal and x + n < st and n < 63 and \
                        line[x + n] == v:
                    n += 1
                if n > 1 or v >= 0xC0:
                    body += bytes((0xC0 | n, v))
                else:
                    body.append(v)
                x += n
    out = bytes(hdr) + bytes(body)
    if trailing is not None:
        out += b"\x0c" + bytes(np.asarray(trailing, np.uint8).ravel())
    return out


def tga(px: np.ndarray, imagetype: int, depth: int, flags: int = 0x20,
        cmap=None, cmap_start: int = 0, cmap_depth: int = 0,
        id_field: bytes = b"", rle_rows: bool = True) -> bytes:
    """A TGA of pixel bytes px (h, w, depth // 8) in file order (the
    caller flips for the origin): raw, or RLE (imagetype & 8) in packets
    within each row (rle_rows) or across rows."""
    h, w = px.shape[:2]
    k = max(depth // 8, 1)
    cmap_bytes = b"" if cmap is None else bytes(cmap)
    clen = 0 if cmap is None else len(cmap_bytes) // max(cmap_depth // 8, 1)
    hdr = struct.pack("<BBBHHBHHHHBB", len(id_field), cmap is not None,
                      imagetype, cmap_start, clen, cmap_depth, 0, 0, w, h,
                      depth, flags)
    data = px.astype(np.uint8).reshape(h, w * k) if depth >= 8 else px
    if not imagetype & 8:
        body = data.tobytes()
    else:
        pixels = data.reshape(h, w, k)
        seqs = [pixels[y] for y in range(h)] if rle_rows else \
            [pixels.reshape(h * w, k)]
        body = bytearray()
        for seq in seqs:
            x, n_all = 0, len(seq)
            while x < n_all:
                n = 1
                while x + n < n_all and n < 128 and \
                        np.array_equal(seq[x + n], seq[x]):
                    n += 1
                if n > 1:
                    body.append(0x80 | (n - 1))
                    body += seq[x].tobytes()
                    x += n
                    continue
                n = 1
                while x + n < n_all and n < 128 and not (
                        x + n + 1 < n_all and
                        np.array_equal(seq[x + n], seq[x + n + 1])):
                    n += 1
                body.append(n - 1)
                body += seq[x:x + n].tobytes()
                x += n
        body = bytes(body)
    return hdr + id_field + cmap_bytes + body


def _sgi_row_rle(line: np.ndarray, bpc: int) -> bytes:
    out = bytearray()
    x, n_all = 0, len(line)

    def atom(v):
        return int(v).to_bytes(bpc, "big")
    while x < n_all:
        n = 1
        while x + n < n_all and n < 127 and line[x + n] == line[x]:
            n += 1
        if n > 2:
            out += atom(n) + atom(line[x])
            x += n
            continue
        n = 1
        while x + n < n_all and n < 127 and not (
                x + n + 2 < n_all and line[x + n] == line[x + n + 1] ==
                line[x + n + 2]):
            n += 1
        out += atom(0x80 | n) + b"".join(atom(v) for v in line[x:x + n])
        x += n
    return bytes(out + atom(0))


def sgi(planes: np.ndarray, bpc: int = 1, rle: bool = False,
        dimension: int = None, lengths=None, rows=None) -> bytes:
    """An SGI file of planes (z, h, w) (rows bottom up as the file holds
    them): raw, or RLE with the offset and length tables (lengths: a
    function (row, channel, true length) -> the table's length; rows: a
    function (row, channel, bytes) -> the bytes written)."""
    z, h, w = planes.shape
    dim = dimension or (1 if h == 1 and z == 1 else 2 if z == 1 else 3)
    hdr = bytearray(512)
    struct.pack_into(">HBBHHHH", hdr, 0, 474, 1 if rle else 0, bpc, dim, w,
                     h, z)
    struct.pack_into(">ii", hdr, 12, 0, 255 if bpc == 1 else 65535)
    hdr[24:28] = b"corp"
    if not rle:
        return bytes(hdr) + planes.astype(">u2" if bpc == 2 else np.uint8
                                           ).tobytes()
    starts, lens, body = [], [], bytearray()
    at = 512 + 8 * z * h
    for c in range(z):
        for y in range(h):
            row = _sgi_row_rle(planes[c, y], bpc)
            if rows is not None:
                row = rows(y, c, row)
            starts.append(at + len(body))
            lens.append(len(row) if lengths is None else
                        lengths(y, c, len(row)))
            body += row
    return bytes(hdr) + struct.pack(f">{z * h}I", *starts) + struct.pack(
        f">{z * h}I", *lens) + bytes(body)


def msp2(bits: np.ndarray, rowmap=None, raw_rows=None) -> bytes:
    """An MSP version 2 file of bits (h, w) (1 is white): each row as runs
    and literals (raw_rows overrides a row's bytes, rowmap the lengths)."""
    h, w = bits.shape
    packed = np.packbits(bits.astype(np.uint8), axis=1)
    coded = []
    for y in range(h):
        line = packed[y]
        out, x = bytearray(), 0
        while x < len(line):
            n = 1
            while x + n < len(line) and n < 255 and line[x + n] == line[x]:
                n += 1
            if n > 2:
                out += bytes((0, n, int(line[x])))
                x += n
                continue
            n = 1
            while x + n < len(line) and n < 255 and not (
                    x + n + 1 < len(line) and line[x + n] == line[x + n + 1]):
                n += 1
            out += bytes((n,)) + line[x:x + n].tobytes()
            x += n
        coded.append(bytes(out) if raw_rows is None or y not in raw_rows
                     else raw_rows[y])
    lengths = [len(c) for c in coded] if rowmap is None else rowmap
    return msp_header(b"LinS", w, h) + struct.pack(f"<{h}H", *lengths) + \
        b"".join(coded)


def msp_header(magic: bytes, w: int, h: int) -> bytes:
    words = list(struct.unpack("<2H", magic)) + [w, h, 1, 1, 1, 1, 0, 0,
                                                   0, 0, 0, 0, 0, 0]
    check = 0
    for v in words:
        check ^= v
    words[12] = check
    return struct.pack("<16H", *words)


def qoi(px: np.ndarray, channels: int, ops: bool = True) -> bytes:
    """A QOI of px (h, w, channels) with every op (INDEX, DIFF, LUMA,
    RUN, RGB, RGBA), the reference encoder's choices; no end marker
    needed by Pillow's decoder, but written."""
    h, w = px.shape[:2]
    flat = px.reshape(-1, channels).astype(np.int64)
    out = bytearray(b"qoif" + struct.pack(">II", w, h) +
                    bytes((channels, 0)))
    seen = [None] * 64
    prev = (0, 0, 0, 255)
    run = 0
    for i, p in enumerate(flat):
        v = tuple(int(c) for c in p) + ((255,) if channels == 3 else ())
        if v == prev and ops:
            run += 1
            if run == 62 or i == len(flat) - 1:
                out.append(0xC0 | (run - 1))
                run = 0
            continue
        if run:
            out.append(0xC0 | (run - 1))
            run = 0
        idx = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64
        if ops and seen[idx] == v:
            out.append(idx)
        elif v[3] != prev[3] or not ops:
            out += b"\xff" + bytes(v)
        else:
            dr, dg, db = ((v[k] - prev[k] + 128) % 256 - 128 for k in range(3))
            dr_dg, db_dg = dr - dg, db - dg
            if -2 <= dr <= 1 and -2 <= dg <= 1 and -2 <= db <= 1:
                out.append(0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2))
            elif -32 <= dg <= 31 and -8 <= dr_dg <= 7 and -8 <= db_dg <= 7:
                out += bytes((0x80 | (dg + 32), (dr_dg + 8) << 4 |
                              (db_dg + 8)))
            else:
                out += b"\xfe" + bytes(v[:3])
        seen[idx] = v
        prev = v
    return bytes(out) + bytes(7) + b"\x01"


def im_file(lines, data: bytes, lut: bytes = None,
            end: bytes = b"\x1a") -> bytes:
    """An IM file: header lines, NULs to byte 511, the end byte, the Lut,
    the data."""
    head = b"".join(line + b"\r\n" for line in lines)
    return head + b"\0" * max(0, 511 - len(head)) + end + (lut or b"") + \
        data


def spider(values: np.ndarray, big: bool = True, stack: bool = False,
           patch=None) -> bytes:
    """A SPIDER 2D image of float values (h, w): the header's label
    records (one of w * 4 bytes, at least 1024 bytes in all), then the
    rows; stack: a stack header and one image after it."""
    h, w = values.shape
    lenbyt = w * 4
    labrec = -(-1024 // lenbyt)
    labbyt = labrec * lenbyt
    hdr = np.zeros(labbyt // 4, np.float32)
    fields = {1: 1, 2: h, 5: 1, 12: w, 13: labrec, 22: labbyt, 23: lenbyt}
    if stack:
        fields.update({24: 2, 26: 1})
    for k, v in fields.items():
        hdr[k - 1] = v
    if patch:
        for k, v in patch.items():
            hdr[k - 1] = v
    dt = ">f4" if big else "<f4"
    head = hdr.astype(dt).tobytes()
    body = values.astype(dt).tobytes()
    if stack:
        image_hdr = hdr.copy()
        image_hdr[23] = 0
        image_hdr[26] = 1
        return head + image_hdr.astype(dt).tobytes() + body
    return head + body


def xbm(bits: np.ndarray, name: bytes = b"im", hot=None,
        upper: bool = False) -> bytes:
    """An X11 bitmap of bits (h, w) (1 is black, shown as 0 by Pillow's
    "1;R" unpacker... as the plugin stores them)."""
    h, w = bits.shape
    packed = np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")
    out = b"#define %s_width %d\n#define %s_height %d\n" % (name, w, name, h)
    if hot is not None:
        out += b"#define %s_x_hot %d\n#define %s_y_hot %d\n" % (
            name, hot[0], name, hot[1])
    fmt = "0x%02X" if upper else "0x%02x"
    vals = [(fmt % v).encode() for v in packed.ravel().tolist()]
    body = b",\n".join(b", ".join(vals[i:i + 12])
                       for i in range(0, len(vals), 12))
    return out + b"static char %s_bits[] = {\n" % name + body + b"\n};\n"


# -- the corpus ---------------------------------------------------------------

def _dib_cases(out: dict):
    rgb = picture(1, 13, 19).astype(np.uint8)
    for mode in ("1", "L", "P", "RGB"):
        out[f"dib_pillow_{mode.lower()}_19x13.dib"] = pillow_written(
            rgb, "DIB", mode)
    idx = picture(2, 9, 11, 1, 16)[..., 0]
    pal = picture(3, 16, 1, 3)[:, 0]
    out["dib_p4_11x9.dib"] = dib(idx, 4, pal)
    out["dib_core12_p8_11x9.dib"] = dib(picture(4, 9, 11, 1)[..., 0], 8,
                                        picture(5, 256, 1, 3)[:, 0], 12)
    out["dib_16bit_11x9.dib"] = dib(picture(6, 9, 11), 16)
    out["dib_32bit_11x9.dib"] = dib(picture(7, 9, 11, 4), 32)
    out["dib_top_down_11x9.dib"] = dib(picture(8, 9, 11), 24, top_down=True)
    whole = dib(picture(9, 9, 11), 24)
    out["dib_cut_11x9.dib"] = whole[:-5]
    out["dib_width0_0x9.dib"] = whole[:4] + bytes(4) + whole[8:]
    out["dib_bits7_11x9.dib"] = whole[:14] + b"\x07\x00" + whole[16:]


def _ico_cases(out: dict):
    from PIL import Image

    rgba = picture(10, 32, 32, 4).astype(np.uint8)
    rgba[..., 3] = np.where(picture(11, 32, 32, 1)[..., 0] > 60, 255, 0)
    out["ico_pillow_png_32x32.ico"] = pillow_written(
        rgba, "ICO", sizes=[(16, 16), (32, 32)])
    rgb = picture(12, 24, 24).astype(np.uint8)
    for mode, bmp in (("RGB", True), ("RGBA", True), ("P", True),
                      ("L", True), ("1", True)):
        im = Image.fromarray(rgba[:24, :24] if mode == "RGBA" else rgb)
        if mode not in ("RGB", "RGBA"):
            im = im.convert(mode)
        out[f"ico_pillow_bmp_{mode.lower()}_24x24.ico"] = pillow_written(
            im, "ICO", sizes=[(24, 24)], bitmap_format="bmp")
    # DIB entries written here: 1, 4 and 8 bits with masks, a PNG entry
    # whose size differs from its directory entry, entries in another order
    idx = picture(13, 16, 16, 1, 16)[..., 0]
    pal = picture(14, 16, 1, 3)[:, 0]
    mask = and_mask(picture(15, 16, 16, 1, 2)[..., 0])
    p4 = dib(idx, 4, pal, height_rows=32) + mask
    p8 = dib(picture(16, 16, 16, 1)[..., 0], 8, picture(17, 256, 1, 3)[:, 0],
             height_rows=32) + mask
    b1 = dib(picture(18, 16, 16, 1, 2)[..., 0], 1, [(0, 0, 0), (255, 0, 0)],
             height_rows=32) + mask
    out["ico_dib_4bit_16x16.ico"] = icon_dir(1, [(16, 16, 16, 4, p4)])
    out["ico_dib_8bit_16x16.ico"] = icon_dir(1, [(16, 16, 0, 8, p8)])
    out["ico_dib_1bit_16x16.ico"] = icon_dir(1, [(16, 16, 2, 1, b1)])
    png20 = pillow_written(picture(19, 20, 20).astype(np.uint8), "PNG")
    out["ico_png_size_differs_20x20.ico"] = icon_dir(
        1, [(8, 8, 0, 32, p8), (16, 16, 0, 32, png20)])
    out["ico_largest_last_16x16.ico"] = icon_dir(
        1, [(8, 8, 0, 8, dib(picture(20, 8, 8, 1)[..., 0], 8,
                             picture(21, 256, 1, 3)[:, 0], height_rows=16)
             + and_mask(np.zeros((8, 8), np.uint8))), (16, 16, 0, 8, p8)])
    rgba32 = dib(picture(22, 16, 16, 4), 32, height_rows=32) + mask
    out["ico_dib_32bit_16x16.ico"] = icon_dir(1, [(16, 16, 0, 32, rgba32)])
    out["ico_dib_32bit_no_alpha_room_16x16.ico"] = icon_dir(
        1, [(16, 16, 0, 32, rgba32[:40 + 16 * 16 * 4 - 8])])
    out["ico_mask_cut_16x16.ico"] = icon_dir(1, [(16, 16, 0, 8, p8)])[:-40]
    out["ico_size_short_16x16.ico"] = icon_dir(1, [(16, 16, 0, 8,
                                                    p8[:-40])])
    # a directory entry of 32 bits over an 8-bit DIB: the alpha bytes
    # Pillow reads past the pixels are not there
    out["ico_bpp32_entry_8bit_dib_16x16.ico"] = icon_dir(
        1, [(16, 16, 0, 32, p8)])
    # two entries of one area: the lower colour depth sorts first
    p8b = dib(picture(23, 16, 16, 1)[..., 0], 8, picture(24, 256, 1, 3)[:, 0],
              height_rows=32) + mask
    out["ico_same_area_depths_16x16.ico"] = icon_dir(
        1, [(16, 16, 0, 8, p8), (16, 16, 0, 4, p8b)])
    # width and height bytes of 0 (256) over a small DIB sort first
    out["ico_dim_byte0_8x8.ico"] = icon_dir(
        1, [(16, 16, 0, 8, p8), (0, 0, 0, 8, dib(
            picture(25, 8, 8, 1)[..., 0], 8, picture(26, 256, 1, 3)[:, 0],
            height_rows=16) + and_mask(np.zeros((8, 8), np.uint8)))])
    # a directory size too small for the 32-bit-padded mask: the mask's
    # offset falls before the file's start
    small = bytearray(icon_dir(1, [(16, 16, 0, 8, p8)]))
    struct.pack_into("<I", small, 14, 40)
    out["ico_entry_size_small_16x16.ico"] = bytes(small)
    # an odd DIB height: the XOR image is its half, rounded down
    out["ico_odd_height_16x15.ico"] = icon_dir(1, [(16, 15, 0, 8, dib(
        picture(27, 16, 16, 1)[..., 0], 8, picture(28, 256, 1, 3)[:, 0],
        height_rows=31) + mask)])
    out["ico_zero_entries_0x0.ico"] = struct.pack("<HHH", 0, 1, 0)
    out["ico_entry_cut_16x16.ico"] = icon_dir(1, [(16, 16, 0, 8, p8)])[:12]
    out["ico_cut_16x16.ico"] = out["ico_pillow_png_32x32.ico"][:-20]


def _cur_cases(out: dict):
    mask = and_mask(picture(30, 16, 16, 1, 2)[..., 0])
    big = dib(picture(31, 16, 16, 4), 32, height_rows=32) + mask
    small = dib(picture(32, 8, 8, 1)[..., 0], 8, picture(33, 256, 1, 3)[:, 0],
                height_rows=16) + and_mask(np.zeros((8, 8), np.uint8))
    out["cur_two_16x16.cur"] = icon_dir(2, [(8, 8, 0, 0, small),
                                            (16, 16, 0, 0, big)])
    out["cur_first_largest_8x8.cur"] = icon_dir(2, [(8, 8, 0, 0, small),
                                                    (8, 16, 0, 0, big)])
    out["cur_24bit_12x10.cur"] = icon_dir(
        2, [(12, 10, 0, 0, dib(picture(34, 10, 12), 24, height_rows=20) +
             and_mask(np.zeros((10, 12), np.uint8)))])
    out["cur_odd_height_12x10.cur"] = icon_dir(
        2, [(12, 10, 0, 0, dib(picture(35, 11, 12), 24, height_rows=21) +
             and_mask(np.zeros((10, 12), np.uint8)))])
    out["cur_none_0x0.cur"] = struct.pack("<HHH", 0, 2, 0)
    out["cur_cut_16x16.cur"] = out["cur_two_16x16.cur"][:-300]


def _pcx_cases(out: dict):
    rgb = picture(40, 13, 21).astype(np.uint8)
    for mode in ("1", "L", "P", "RGB"):
        out[f"pcx_pillow_{mode.lower()}_21x13.pcx"] = pillow_written(
            rgb, "PCX", mode)
    out["pcx_pillow_rgb_even_20x13.pcx"] = pillow_written(rgb[:, :20], "PCX")
    # 1 bit, 2 and 4 planes (P;2L, P;4L) with the header's 16 colours
    for planes in (2, 4):
        st = 2
        rows = picture(41 + planes, 9, planes * st, 1)[..., 0].reshape(
            9, planes, st)
        out[f"pcx_1bit_{planes}planes_13x9.pcx"] = pcx(
            rows, 1, 2, palette16=picture(43, 16, 1, 3)[:, 0], stride=13)
        out[f"pcx_1bit_{planes}planes_odd_stride_3x9.pcx"] = pcx(
            picture(44 + planes, 9, planes * 2, 1)[..., 0].reshape(
                9, planes, 2), 1, 2, palette16=picture(45, 16, 1, 3)[:, 0],
            stride=3, provided=1)
        # planes padded to 2 bytes (the header's stride differs): Pillow
        # moves each plane next to the one before
        out[f"pcx_1bit_{planes}planes_padded_3x9.pcx"] = pcx(
            picture(47 + planes, 9, planes * 2, 1)[..., 0].reshape(
                9, planes, 2), 1, 2, palette16=picture(49, 16, 1, 3)[:, 0],
            stride=3, provided=2)
    grey = picture(46, 7, 11, 1)[..., 0]
    ramp = np.repeat(np.arange(256)[:, None], 3, 1)
    out["pcx_grey_ramp_palette_11x7.pcx"] = pcx(
        grey.reshape(7, 1, 11), 8, trailing=ramp, stride=11, provided=11)
    out["pcx_l_odd_stride_11x7.pcx"] = pcx(
        np.concatenate([grey, np.zeros((7, 1), np.int64)], 1).reshape(
            7, 1, 12), 8, stride=11, provided=12)
    out["pcx_literals_11x7.pcx"] = pcx(grey.reshape(7, 1, 11) % 0xC0, 8,
                                       stride=11, literal=True)
    whole = out["pcx_pillow_rgb_21x13.pcx"]
    out["pcx_cut_21x13.pcx"] = whole[:-30]
    # a run past the row's buffer
    bad = bytearray(pcx(grey.reshape(7, 1, 11), 8, stride=11))
    bad[128:130] = b"\xff\x05"
    out["pcx_run_overrun_11x7.pcx"] = bytes(bad)
    out["pcx_version4_8bit_11x7.pcx"] = pcx(grey.reshape(7, 1, 11), 8, 4,
                                            stride=11)
    out["pcx_bad_box_0x0.pcx"] = whole[:8] + b"\x00\x00" + whole[10:]


def _dcx_cases(out: dict):
    a = out["pcx_pillow_rgb_21x13.pcx"]
    b = out["pcx_pillow_l_21x13.pcx"]
    head = struct.pack("<I", 0x3ADE68B1)
    offs = struct.pack("<III", 16, 16 + len(a), 0)
    out["dcx_two_frames_21x13.dcx"] = head + offs + a + b
    out["dcx_second_first_21x13.dcx"] = head + struct.pack(
        "<III", 16 + len(a), 16, 0) + a + b
    out["dcx_no_frames_0x0.dcx"] = head + bytes(4)
    out["dcx_cut_21x13.dcx"] = (head + offs + a)[:-40]


def _msp_cases(out: dict):
    bits = picture(50, 11, 29, 1, 2)[..., 0]
    from PIL import Image
    out["msp_pillow_v1_29x11.msp"] = pillow_written(
        Image.fromarray((bits * 255).astype(np.uint8)).convert("1"), "MSP")
    out["msp_v2_29x11.msp"] = msp2(bits)
    blocky = np.repeat(np.repeat(bits[:4, :8], 3, 0), 5, 1)
    out["msp_v2_runs_40x12.msp"] = msp2(blocky)
    rowmap = None
    h = 11
    base = msp2(bits)
    lens = list(struct.unpack_from(f"<{h}H", base, 32))
    lens[3] = 0
    out["msp_v2_blank_row_29x11.msp"] = msp_header(b"LinS", 29, 11) + \
        struct.pack(f"<{h}H", *lens) + base[32 + 2 * h:]
    out["msp_v2_run_cut_29x11.msp"] = msp2(bits, raw_rows={2: b"\x00\x03"})
    # a run cut short where a long row before it leaves enough bytes
    out["msp_v2_run_cut_long_row_29x11.msp"] = msp2(
        bits, raw_rows={0: b"\x08" + bytes(range(1, 9)), 2: b"\x00\x03"})
    out["msp_v2_long_row_29x11.msp"] = msp2(bits, raw_rows={0: b"\x06" + bytes(
        range(1, 7))})
    out["msp_v2_short_29x11.msp"] = base[:-4]
    out["msp_bad_checksum_29x11.msp"] = base[:24] + b"\x01\x00" + base[26:]
    out["msp_v1_cut_29x11.msp"] = out["msp_pillow_v1_29x11.msp"][:-3]
    del rowmap


def _qoi_cases(out: dict):
    rgb = picture(60, 14, 17).astype(np.uint8)
    rgba = picture(61, 14, 17, 4).astype(np.uint8)
    out["qoi_pillow_rgb_17x14.qoi"] = pillow_written(rgb, "QOI")
    out["qoi_pillow_rgba_17x14.qoi"] = pillow_written(rgba, "QOI")
    smooth = (np.cumsum(grid(62, (14, 17, 3), 3) - 1, 1) + 100) % 256
    blocky = np.repeat(np.repeat(grid(63, (3, 4, 4), 4) * 60, 5, 0), 5, 1)
    out["qoi_ops_rgb_17x14.qoi"] = qoi(smooth, 3)
    out["qoi_ops_rgba_20x15.qoi"] = qoi(blocky, 4)
    out["qoi_rgb_ops_channels4_17x14.qoi"] = qoi(
        np.concatenate([smooth, np.full((14, 17, 1), 255)], -1), 4)
    hand = b"qoif" + struct.pack(">II", 4, 2) + b"\x03\x00" + bytes(
        [0x05, 0x10, 0x6A, 0x90, 0x88, 0xC1, 0xFE, 9, 8, 7, 0x3B])
    out["qoi_index_unset_4x2.qoi"] = hand
    # an unset index is 0, 0, 0, 0: its alpha carries into the next pixel's
    # hash
    out["qoi_index_alpha_4x1.qoi"] = b"qoif" + struct.pack(">II", 4, 1) + \
        b"\x03\x00" + bytes([0x05, 0xFE, 9, 8, 7, 0x34, 0x00]) + bytes(8)
    out["qoi_channels5_4x2.qoi"] = hand[:12] + b"\x05" + hand[13:]
    out["qoi_cut_17x14.qoi"] = out["qoi_pillow_rgb_17x14.qoi"][:-40]
    out["qoi_cut_in_rgba_op_17x14.qoi"] = qoi(rgba, 4, ops=False)[:-3]


def _sgi_cases(out: dict):
    for mode, ch in (("L", 1), ("RGB", 3), ("RGBA", 4)):
        px = picture(70 + ch, 9, 13, ch).astype(np.uint8)
        arr = px[..., 0] if ch == 1 else px
        out[f"sgi_pillow_{mode.lower()}_13x9.sgi"] = pillow_written(arr, "SGI")
        out[f"sgi_pillow_{mode.lower()}_16bit_13x9.sgi"] = pillow_written(
            arr, "SGI", bpc=2)
    for ch in (1, 3, 4):
        planes = np.repeat(grid(80 + ch, (ch, 9, 4), 6) * 40, 4,
                           axis=2)[:, :, :13]
        out[f"sgi_rle_{ch}ch_13x9.sgi"] = sgi(planes, 1, True)
        out[f"sgi_rle16_{ch}ch_13x9.sgi"] = sgi(planes * 257 + 3, 2, True)
    planes = np.repeat(grid(85, (3, 9, 4), 6) * 40, 4, axis=2)[:, :, :13]
    # a row whose chunk count stops on a run (the image stops there)
    out["sgi_rle_short_count_13x9.sgi"] = sgi(
        planes, 1, True, lengths=lambda y, c, n: 1 if (y, c) == (4, 1)
        else n)
    # a run past the row's end, a length past the file
    out["sgi_rle_overrun_13x9.sgi"] = sgi(
        planes, 1, True, rows=lambda y, c, r: b"\x0f\x07\x00" if
        (y, c) == (2, 0) else r)
    out["sgi_rle_length_past_end_13x9.sgi"] = sgi(
        planes, 1, True, lengths=lambda y, c, n: n + 5000 if (y, c) == (8, 2)
        else n)
    # a length past 2^31 is a negative count: the row expands nothing and
    # keeps the last row's bytes
    out["sgi_rle_length_negative_13x9.sgi"] = sgi(
        planes, 1, True, lengths=lambda y, c, n: 0x8DFF0000 if (y, c) == (
            2, 0) else n)
    out["sgi_rle_zero_ends_row_13x9.sgi"] = sgi(
        planes, 1, True, rows=lambda y, c, r: b"\x03\x09\x00" if
        (y, c) == (3, 2) else r)
    out["sgi_dimension1_13x1.sgi"] = sgi(planes[:1, :1], 1, dimension=1)
    out["sgi_cut_13x9.sgi"] = out["sgi_pillow_rgb_13x9.sgi"][:-20]
    out["sgi_rle_cut_13x9.sgi"] = out["sgi_rle_3ch_13x9.sgi"][:-30]
    out["sgi_bad_mode_13x9.sgi"] = sgi(planes[:2], 1)
    out["sgi_compression2_13x9.sgi"] = b"\x01\xda\x02" + \
        out["sgi_pillow_l_13x9.sgi"][3:]


def _spider_cases(out: dict):
    out["spider_pillow_15x11.spi"] = pillow_written(
        (np.random.default_rng(90).standard_normal((11, 15)) * 90 +
         100).astype(np.float32), "SPIDER")
    vals = (np.random.default_rng(91).standard_normal((7, 9)) * 120 +
            90).astype(np.float32)
    vals[0, :4] = [np.nan, np.inf, -np.inf, 255.7]
    out["spider_big_9x7.spi"] = spider(vals, True)
    out["spider_little_9x7.spi"] = spider(vals, False)
    out["spider_stack_9x7.spi"] = spider(vals, True, stack=True)
    out["spider_imgnumber_9x7.spi"] = spider(vals, True, patch={27: 1})
    out["spider_iform3_9x7.spi"] = spider(vals, True, patch={5: 3})
    out["spider_not_int_9x7.spi"] = spider(vals, True, patch={2: 7.5})
    out["spider_istack_nan_9x7.spi"] = spider(vals, True,
                                              patch={24: float("nan")})
    out["spider_cut_9x7.spi"] = out["spider_big_9x7.spi"][:-9]


def _tga_cases(out: dict):
    rgb = picture(100, 11, 17).astype(np.uint8)
    rgba = picture(101, 11, 17, 4).astype(np.uint8)
    blocky = np.repeat(np.repeat(grid(102, (4, 4, 4), 3) * 80, 3, 0), 5,
                       1)[:11, :17].astype(np.uint8)
    from PIL import Image
    for mode, src in (("L", rgb), ("LA", rgba), ("P", rgb), ("RGB", rgb),
                      ("RGBA", rgba), ("RGB", blocky[..., :3]),
                      ("RGBA", blocky)):
        im = Image.fromarray(src)
        if im.mode != mode:
            im = im.convert(mode)
        tag = "blocky_" if src is blocky or src.base is blocky else ""
        for rle in (False, True):
            for orient in (-1, 1):
                name = (f"tga_pillow_{tag}{mode.lower()}_"
                        f"{'rle' if rle else 'raw'}_"
                        f"{'bottom' if orient < 0 else 'top'}_17x11.tga")
                out[name] = pillow_written(im, "TGA", rle=rle,
                                           orientation=orient)
    out["tga_pillow_id_field_17x11.tga"] = pillow_written(
        Image.fromarray(rgb), "TGA", id_section=b"an id field")
    # 16-bit pixels (BGRA;15Z) and colour maps of 16, 24 and 32 bits with
    # a first entry above 0, under each origin flag
    p16 = picture(103, 7, 9, 2).astype(np.uint8)
    for flags in (0x00, 0x10, 0x20, 0x30):
        out[f"tga_16bit_flags{flags:02x}_9x7.tga"] = tga(p16, 2, 16, flags)
        out[f"tga_16bit_rle_flags{flags:02x}_9x7.tga"] = tga(p16, 10, 16,
                                                             flags)
        idx = picture(104, 7, 9, 1, 20)[..., 0] + 3
        for cd in (16, 24, 32):
            cmap = picture(105 + cd, 20, 1, cd // 8)[:, 0].astype(
                np.uint8).tobytes()
            out[f"tga_cmap{cd}_flags{flags:02x}_9x7.tga"] = tga(
                idx[..., None], 1, 8, flags, cmap, 3, cd)
        out[f"tga_cmap24_rle_flags{flags:02x}_9x7.tga"] = tga(
            idx[..., None], 9, 8, flags, picture(108, 20, 1, 3)[:, 0].astype(
                np.uint8).tobytes(), 3, 24)
    idx = picture(109, 7, 9, 1, 40)[..., 0]
    out["tga_cmap24_index_past_map_9x7.tga"] = tga(
        idx[..., None], 1, 8, 0x20, picture(110, 20, 1, 3)[:, 0].astype(
            np.uint8).tobytes(), 0, 24)
    out["tga_cmap24_257_entries_9x7.tga"] = tga(
        idx[..., None], 1, 8, 0x20, picture(111, 250, 1, 3)[:, 0].astype(
            np.uint8).tobytes(), 7, 24)
    out["tga_cmap15_depth_9x7.tga"] = tga(
        idx[..., None], 1, 8, 0x20, picture(112, 20, 1, 2)[:, 0].astype(
            np.uint8).tobytes(), 0, 15)
    out["tga_type1_no_map_9x7.tga"] = tga(idx[..., None], 1, 8, 0x20)
    out["tga_rle_across_rows_17x11.tga"] = tga(
        blocky[..., :3][..., ::-1], 10, 24, 0x20, rle_rows=False)
    out["tga_grey_rle_across_rows_17x11.tga"] = tga(
        blocky[..., :1], 11, 8, 0x20, rle_rows=False)
    # literals that run on into the next rows (no two pixels alike), and a
    # run across a row's end (one colour)
    out["tga_rle_literals_across_rows_17x11.tga"] = tga(
        rgb[..., ::-1], 10, 24, 0x20, rle_rows=False)
    out["tga_rle_run_across_rows_17x2.tga"] = tga(
        np.full((2, 17, 3), 77, np.uint8), 10, 24, 0x20, rle_rows=False)
    # a run of 20 over a row of 17, then a run of 17: Pillow refuses the
    # first, so no clipped row is ever used
    out["tga_rle_run_over_row_17x2.tga"] = tga(
        np.zeros((1, 0, 3), np.uint8), 10, 24, 0x20)[:12] + struct.pack(
        "<HHBB", 17, 2, 24, 0x20) + bytes([0x93, 1, 2, 3, 0x90, 4, 5, 6])
    # grey images with a colour map convert through it
    gidx = picture(114, 7, 9, 1, 20)[..., 0].astype(np.uint8)
    out["tga_grey_cmap24_9x7.tga"] = tga(
        gidx[..., None], 3, 8, 0x20, picture(115, 20, 1, 3)[:, 0].astype(
            np.uint8).tobytes(), 0, 24)
    out["tga_la_cmap16_9x7.tga"] = tga(
        np.stack([gidx, gidx + 100], -1), 3, 16, 0x20,
        picture(116, 20, 1, 2)[:, 0].astype(np.uint8).tobytes(), 0, 16)
    out["tga_1bit_raw_16x7.tga"] = tga(
        np.packbits(picture(113, 7, 16, 1, 2)[..., 0], axis=1)[..., None]
        .reshape(7, 2, 1), 3, 1, 0x20)
    whole = out["tga_pillow_rgb_rle_top_17x11.tga"]
    # Pillow's writer ends a file with TGA 2.0's 26-byte footer
    out["tga_rle_cut_17x11.tga"] = whole[:-26 - 7]
    out["tga_raw_cut_17x11.tga"] = out["tga_pillow_rgb_raw_top_17x11.tga"][
        :-26 - 7]
    out["tga_bad_depth_17x11.tga"] = whole[:16] + b"\x07" + whole[17:]
    out["tga_type5_17x11.tga"] = whole[:2] + b"\x05" + whole[3:]
    out["tga_orientation_bits_17x11.tga"] = whole[:17] + b"\x28" + whole[18:]


def _xbm_cases(out: dict):
    bits = picture(120, 9, 21, 1, 2)[..., 0]
    from PIL import Image
    im = Image.fromarray((bits * 255).astype(np.uint8)).convert("1")
    out["xbm_pillow_21x9.xbm"] = pillow_written(im, "XBM")
    out["xbm_pillow_hotspot_21x9.xbm"] = pillow_written(im, "XBM",
                                                        hotspot=(3, 4))
    out["xbm_upper_hex_21x9.xbm"] = xbm(bits, upper=True)
    out["xbm_hot_defines_21x9.xbm"] = xbm(bits, b"x", hot=(1, 2))
    out["xbm_leading_space_21x9.xbm"] = b"  \n" + xbm(bits)
    odd = xbm(bits).replace(b"0x", b"0X", 3).replace(b"0x", b"0xg", 1)
    out["xbm_odd_digits_21x9.xbm"] = odd
    out["xbm_cut_21x9.xbm"] = xbm(bits)[:-40]
    out["xbm_no_bits_21x9.xbm"] = xbm(bits).replace(b"_bits[]", b"_data[]")
    out["xbm_crlf_21x9.xbm"] = xbm(bits).replace(b"\n", b"\r\n")


def _im_cases(out: dict):
    from PIL import Image
    rgb = picture(130, 9, 13).astype(np.uint8)
    rgba = picture(131, 9, 13, 4).astype(np.uint8)
    for mode in ("1", "L", "LA", "P", "RGB", "RGBA", "RGBX", "CMYK",
                 "YCbCr"):
        src = rgba if mode in ("LA", "RGBA", "CMYK") else rgb
        im = Image.fromarray(src).convert(mode) if mode != "CMYK" else \
            Image.frombytes("CMYK", (13, 9), src.tobytes())
        out[f"im_pillow_{mode.lower()}_13x9.im"] = pillow_written(im, "IM")
    wide = picture(132, 9, 13, 1, 70000)[..., 0]
    for mode in ("I", "I;16", "I;16L", "I;16B"):
        arr = wide.astype(np.int32) - 3000 if mode == "I" else \
            wide.astype(np.uint16)
        im = Image.fromarray(arr)
        if mode != im.mode:
            im = im.convert(mode) if mode != "I;16L" else \
                Image.frombytes("I;16L", (13, 9), arr.astype("<u2").tobytes())
        name = mode.lower().replace(";", "")
        out[f"im_pillow_{name}_13x9.im"] = pillow_written(im, "IM")
    f = (np.random.default_rng(133).standard_normal((9, 13)) * 150 +
         100).astype(np.float32)
    out["im_pillow_f_13x9.im"] = pillow_written(f, "IM")
    size = b"Image size (x*y): 13*9"
    # planar RGB (the G, R and B planes whole), 8- and 16-bit floats
    planes = grid(134, (3, 9, 13), 256).astype(np.uint8)
    for kind in (b"RGB3", b"RYB3"):
        out[f"im_{kind.decode().lower()}_13x9.im"] = im_file(
            [b"Image type: " + kind + b" image", size],
            planes[:, ::-1].tobytes())
    for kind, dt in ((b"L 8", "u1"), (b"L 8S", "i1"), (b"L 16", "<u2"),
                     (b"L 16S", "<i2"), (b"L 32", "<u4"),
                     (b"L*32F", "<f4"), (b"L 32 F", "<i4"),
                     (b"L 32 S", "<i4"), (b"L*16B", ">u2")):
        vals = picture(135, 9, 13, 1, 250)[..., 0]
        name = kind.decode().lower().replace(" ", "_").replace("*", "x")
        out[f"im_{name}_13x9.im"] = im_file(
            [b"Image type: " + kind + b" image", size],
            vals[::-1].astype(dt).tobytes())
    # L*5: 5-bit values, least significant first, rows from a byte
    vals = picture(136, 9, 13, 1, 32)[..., 0]
    body = b""
    for row in vals[::-1]:
        acc = 0
        for k, v in enumerate(row.tolist()):
            acc |= v << (5 * k)
        body += acc.to_bytes((13 * 5 + 7) // 8, "little")
    out["im_bits5_13x9.im"] = im_file([b"Image type: L*5 image", size], body)
    out["im_bits33_13x9.im"] = im_file([b"Image type: L*33 image", size],
                                       body)
    idx = picture(137, 9, 13, 1, 4)[..., 0]
    out["im_b2_13x9.im"] = im_file(
        [b"Image type: B2 image", size],
        np.packbits(np.unpackbits(idx[::-1].astype(np.uint8)[..., None],
                                  axis=2)[..., 6:].reshape(9, -1),
                    axis=1).tobytes())
    idx16 = picture(138, 9, 13, 1, 16)[..., 0]
    out["im_b4_13x9.im"] = im_file(
        [b"Image type: B4 image", size],
        np.packbits(np.unpackbits(idx16[::-1].astype(np.uint8)[..., None],
                                  axis=2)[..., 4:].reshape(9, -1),
                    axis=1).tobytes())
    lut = picture(139, 3, 256, 1)[..., 0].astype(np.uint8).tobytes()
    grey_lut = bytes(255 - i for i in range(256)) * 3
    linear = bytes(range(256)) * 3
    data = picture(140, 9, 13, 1)[..., 0].astype(np.uint8).tobytes()
    for tag, table in ((b"colour", lut), (b"grey", grey_lut),
                       (b"linear", linear)):
        out[f"im_lut_{tag.decode()}_13x9.im"] = im_file(
            [b"Image type: Greyscale image", size, b"Lut: 1"], data,
            lut=table)
    out["im_lut_la_13x9.im"] = im_file(
        [b"Image type: LA image", size, b"Lut: 1"], data + data, lut=lut)
    # a Lut cut short whose first two thirds never match (Pillow's check
    # compares the third only where they do): open, then refused
    out["im_lut_short_13x9.im"] = im_file(
        [b"Image type: Greyscale image", size, b"Lut: 1"], b"",
        lut=bytes(range(256)) + bytes((i + 1) % 256 for i in range(256)) +
        bytes(28))
    out["im_lut_cut_13x9.im"] = im_file(
        [b"Image type: Greyscale image", size, b"Lut: 1"], b"", lut=lut[:500])
    out["im_rlb_13x9.im"] = im_file([b"Image type: RLB image", size],
                                    rgb.tobytes())
    out["im_default_size_13x9.im"] = im_file([b"Name: x", b"Comment: y"],
                                             bytes(512 * 512))
    out["im_mode_l_13x9.im"] = im_file([b"Image type: L", size], data)
    out["im_mode_rgb_raw_l_13x9.im"] = im_file([b"Image type: RGB", size],
                                               data * 3)
    # a mode named outright keeps the default raw mode, L: P reads it as
    # indices, LAB as its L band
    out["im_mode_p_raw_l_13x9.im"] = im_file([b"Image type: P", size], data)
    out["im_mode_lab_raw_l_13x9.im"] = im_file([b"Image type: LAB", size],
                                               data)
    # a mode named after an OPEN entry keeps that entry's raw mode
    planes3 = grid(141, (3, 9, 13), 256).astype(np.uint8).tobytes()
    for first, mode, body in ((b"RGB3 image", b"RGBX", planes3),
                              (b"LA image", b"RGBA", data + data),
                              (b"L 16B image", b"I;16", data + data)):
        name = "im_mode_%s_after_%s_13x9.im" % (
            mode.decode().lower().replace(";", ""),
            first[:-6].decode().lower().replace(" ", ""))
        out[name] = im_file(
            [b"Image type: " + first, b"Image type: " + mode, size], body)
    out["im_size_float_13x9.im"] = im_file(
        [b"Image type: Greyscale image", b"Image size (x*y): 13.0*9"], data)
    out["im_size_one_13x9.im"] = im_file(
        [b"Image type: Greyscale image", b"Image size (x*y): 13"], data)
    out["im_size_bad_13x9.im"] = im_file(
        [b"Image type: Greyscale image", b"Image size (x*y): 13*x"], data)
    out["im_no_tags_13x9.im"] = im_file([b"Other: 1"], data)
    out["im_syntax_13x9.im"] = im_file([b"Image type: Greyscale image",
                                        b"no colon here"], data)
    out["im_no_end_13x9.im"] = b"Image type: Greyscale image\r\n" + size + \
        b"\r\n"
    out["im_cut_13x9.im"] = out["im_pillow_rgb_13x9.im"][:-11]
    out["im_long_line_13x9.im"] = im_file([b"Name: " + b"n" * 120, size],
                                          data)


def _routing_cases(out: dict):
    """Files whose first bytes two plugins' accept functions take: the
    plugin Pillow tries first decides."""
    p16 = picture(150, 7, 9, 2).astype(np.uint8)
    # a TGA that CUR's accept takes (id 0, no map, type 2, a map start of
    # 0): CUR finds no cursors and passes it on, TGA reads it
    out["tga_cur_prefix_9x7.tga"] = tga(p16, 2, 16, 0x20)
    # a TGA that ICO's accept takes (type 1 without a map): ICO's open
    # fails, and Pillow's open with it
    idx = picture(151, 7, 9, 1)[..., 0]
    out["tga_ico_prefix_9x7.tga"] = tga(idx[..., None], 1, 8, 0x20)
    # a DIB whose header is also a TGA's
    out["dib_tga_shaped_11x9.dib"] = dib(picture(152, 9, 11), 24)
    # headers IMT, IPTC and PCD open: left to PIL
    out["imt_header_4x3.imt"] = b"width 4\nheight 3\npixel n8\n\x0c" + \
        bytes(12)
    out["iptc_header_2x2.iptc"] = bytes.fromhex(
        "1c033c0002010000") + b"" + bytes.fromhex(
        "1c0314000102") + bytes.fromhex("1c031e000102") + \
        bytes.fromhex("1c03780001011c080a000400000000")
    out["pcd_header_768x512.pcd"] = bytes(2048) + b"PCD_" + bytes(1535)
    # an IM header whose first line is also a TGA header (a type 3 grey
    # image): IM is tried first
    tga_line = b"A\x00\x03" + bytes(9) + struct.pack("<HH", 6, 5) + \
        b"\x08\x20: x"
    out["im_tga_both_6x5.im"] = im_file(
        [tga_line, b"Image type: Greyscale image", size_line(6, 5)],
        picture(154, 5, 6, 1)[..., 0].astype(np.uint8).tobytes())
    # garbage that TGA's and SPIDER's opens would read, were they tried
    # first: IM's header takes it
    out["im_tga_shaped_13x9.im"] = im_file(
        [b"Image type: Greyscale image", size_line(13, 9)],
        picture(153, 9, 13, 1)[..., 0].astype(np.uint8).tobytes())


def size_line(w: int, h: int) -> bytes:
    return b"Image size (x*y): %d*%d" % (w, h)


def cases() -> dict:
    """{file name: bytes}."""
    out = {}
    _dib_cases(out)
    _ico_cases(out)
    _cur_cases(out)
    _pcx_cases(out)
    _dcx_cases(out)
    _msp_cases(out)
    _qoi_cases(out)
    _sgi_cases(out)
    _spider_cases(out)
    _tga_cases(out)
    _xbm_cases(out)
    _im_cases(out)
    _routing_cases(out)
    return out


# -- the scenes, made at run time ---------------------------------------------

def ico_png(rgb: np.ndarray) -> bytes:
    """A PNG of rgb (filter 0, zlib level 6), for an ICO entry."""
    h, w = rgb.shape[:2]
    raw = b"".join(b"\0" + rgb[y].tobytes() for y in range(h))

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, 2, 0, 0, 0)) + chunk(
        b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b"")


def scene_cases(rgb: np.ndarray) -> dict:
    """The 640x480 scene as TGA RLE (bottom up, BGR), PCX RGB (three
    planes), SGI RLE (three channels), QOI, IM (RGB;L), SPIDER (its grey as
    big-endian floats) and XBM (its grey below its mean), and its top-left
    256x256 as a 32-bit DIB entry of an ICO: numpy alone."""
    h, w = rgb.shape[:2]
    grey = rgb.astype(np.int64).sum(-1) // 3
    quant = (rgb // 16 * 16).astype(np.uint8)      # runs for the RLE coders
    sq = rgb[:256, :256]
    alpha = np.full((256, 256, 1), 255, np.uint8)
    ico = icon_dir(1, [(0, 0, 0, 32, dib(np.concatenate([sq, alpha], -1),
                                         32, height_rows=512) +
                        and_mask(np.zeros((256, 256), np.uint8)))])
    return {
        "scene_tga_rle_640x480.tga": tga(quant[::-1, :, ::-1], 10, 24, 0x00),
        "scene_pcx_rgb_640x480.pcx": pcx(
            quant.transpose(0, 2, 1), 8, stride=w, provided=w),
        "scene_sgi_rle_640x480.sgi": sgi(
            quant.transpose(2, 0, 1)[:, ::-1], 1, True),
        "scene_qoi_640x480.qoi": qoi(quant, 3),
        "scene_im_640x480.im": im_file(
            [b"Image type: RGB image", size_line(w, h)],
            rgb[::-1].transpose(0, 2, 1).tobytes()),
        "scene_spider_640x480.spi": spider(grey.astype(np.float32) + 0.25),
        "scene_xbm_640x480.xbm": xbm((grey < grey.mean()).astype(np.uint8)),
        "scene_ico_256x256.ico": ico,
    }


def made() -> dict:
    """The scenes (numpy alone: the card makes them too)."""
    fixtures = _sibling("torch_jpeg_fixtures")
    return scene_cases(fixtures.scene(0))


def load(folder: str = FOLDER, name: str = DIGESTS) -> dict:
    with open(os.path.join(folder, name)) as f:
        return json.load(f)


def _dump(path: str, digests: dict):
    with open(path, "w") as f:
        f.write("{\n" + ",\n".join(
            f" {json.dumps(k)}: {json.dumps(v, sort_keys=True)}"
            for k, v in digests.items()) + "\n}\n")


def write(folder: str = FOLDER) -> dict:
    """Write every committed case and digests.json (the made scenes' too)
    into folder; returns the digests."""
    import tempfile
    import warnings

    tc = _sibling("torch_tiff_corpus")
    os.makedirs(folder, exist_ok=True)
    digests = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, data in sorted(cases().items()):
            path = os.path.join(folder, name)
            with open(path, "wb") as f:
                f.write(data)
            digests[name] = tc.reference(path)
        with tempfile.TemporaryDirectory() as tmp:
            for name, data in sorted(made().items()):
                path = os.path.join(tmp, name)
                with open(path, "wb") as f:
                    f.write(data)
                digests[name] = tc.reference(path)
    _dump(os.path.join(folder, DIGESTS), dict(sorted(digests.items())))
    return digests


if __name__ == "__main__":
    print(json.dumps(write(*sys.argv[1:]), indent=1, sort_keys=True))
