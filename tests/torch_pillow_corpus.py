"""The corpus of the JAX package's Pillow routes (tests/fixtures/
torch_pillow_corpus/): the files the JAX package hands to Pillow 12.1.0,
which the port decodes in its own C (csrc/jpeg_decode.cc in its Pillow
mode, csrc/bmp_decode.cc, csrc/gif_decode.cc).

Small files made from numpy seeds, one for each case the port must take as
Pillow takes it:

- JPEG, written through Pillow's own libjpeg-turbo 3.1.3 (the writer
  tests/torch_pillow_jpeg_writer.c): CMYK and YCCK files, baseline and
  progressive, at each sampling of tests/torch_jpeg_corpus.py (the first
  and the last component at it, the middle two 1x1), without an Adobe
  marker, with Adobe transform 1, arithmetic coded, with restart markers,
  never refined (smoothed), cut; 8-bit lossless files (SOF3) at the seven
  predictors, a point transform, grey, CMYK, restart markers, one scan a
  component, sampling factors patched to 4:2:0; a lossless CMYK file whose
  256 x 256 pixels hold every (c, k) pair; lossless files Pillow refuses
  (YCbCr, which libjpeg does not convert losslessly; SOF11; cut; a
  component without its scan); progressive files whose block smoothing
  pins libjpeg-turbo 3.1's window (two rows up in the second iMCU row,
  one row up in a second iMCU row that is the last and holds one block
  row, two rows down into the padded rows, the nearest column in a
  component two blocks wide, two rows down clipped in the last iMCU row),
  and a copy of tests/torch_jpeg_corpus.py's unrefined 640x480 scene;
- BMP, written by this module's ``bmp``: OS/2 core, BITMAPINFOHEADER, V4
  and V5 headers; 1, 4, 8, 16, 24 and 32 bits; BI_BITFIELDS layouts; RLE8
  and RLE4 with end-of-line, delta and absolute runs; top-down rows; grey
  palettes (Pillow's "1" and "L"), a short palette, a data offset pointing
  just after the header; files Pillow refuses;
- GIF, written by this module's ``gif`` (its own LZW encoder): global and
  local tables, a grey local table over a global one, no table,
  interlace, a frame smaller than the screen at an offset over a
  transparent index, a frame growing the screen, code sizes 2 to 8, clear
  codes, a table that fills to 4096 codes, extensions, a short table;
  files Pillow refuses (cut, an early end code, a bad code, no image, code
  size 13);
- a 640x480 scene (tests/torch_jpeg_fixtures.py:scene 0) in each format:
  CMYK, YCCK and lossless JPEG, 8-bit BMP, GIF.

``digests.json`` holds, for each file, the sha256 of each JAX route's
pixels on this machine, null where it fails: ``loader`` is the JAX
server's ``_decode_image`` (its libjpeg-turbo 2.1 for a JPEG it decodes,
Pillow for the rest: the server, the loader, detect ``--all``), ``img``
is ``np.asarray(Image.open(f).convert("RGB"))`` (detect ``--img``), and
``hw`` the (h, w) Pillow's open reads. ``chip_smoke.py`` holds the port to
them on a machine without Pillow. Remake the corpus (Pillow, the JAX
package and g++ with the system's jpeglib.h needed) with

  python -m tests.torch_pillow_corpus [folder]

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

FOLDER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                      "torch_pillow_corpus")
DIGESTS = "digests.json"
WRITER_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "torch_pillow_jpeg_writer.c")

# J_COLOR_SPACE
GRAY, RGB, YCC, CMYK, YCCK = 1, 2, 3, 4, 5


# -- JPEG through Pillow's libjpeg-turbo 3.1.3 --------------------------------

def pillow_libjpeg() -> str:
    """The libjpeg-turbo Pillow bundles (pillow.libs/libjpeg-*.so.62.4.0)."""
    import PIL

    found = glob.glob(os.path.join(os.path.dirname(os.path.dirname(
        PIL.__file__)), "pillow.libs", "libjpeg-*.so.62.4.0"))
    if not found:
        raise RuntimeError("Pillow bundles no libjpeg-turbo 3 here")
    return found[0]


@functools.cache
def _writer():
    """tests/torch_pillow_jpeg_writer.c built against Pillow's libjpeg into
    build/tests (named by a digest of the source and the library)."""
    lib_path = pillow_libjpeg()
    with open(WRITER_SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read() + lib_path.encode()).hexdigest()[:16]
    path = os.path.join(jcorpus.WRITER_DIR, f"libpillow_jpeg_writer_{tag}.so")
    if not os.path.isfile(path):
        os.makedirs(jcorpus.WRITER_DIR, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-o", tmp,
                        WRITER_SOURCE, lib_path,
                        f"-Wl,-rpath,{os.path.dirname(lib_path)}"],
                       check=True, capture_output=True)
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    u8p, ip, i = (ctypes.POINTER(ctypes.c_uint8),
                  ctypes.POINTER(ctypes.c_int), ctypes.c_int)
    lib.pw_encode.argtypes = [u8p, i, i, i, i, i, ip, i, i, i, i, ip, i, i, i,
                              i, ctypes.POINTER(u8p),
                              ctypes.POINTER(ctypes.c_ulong)]
    lib.pw_encode.restype = ctypes.c_int
    lib.pw_free.argtypes = [u8p]
    lib.pw_free.restype = None
    return lib


def encode(arr: np.ndarray, space: int, samp, quality: int = 90,
           progressive: bool = False, arithmetic: bool = False,
           restart: int = 0, scans=None, adobe: int = -1, psv: int = 0,
           pt: int = 0) -> bytes:
    """arr ((h, w) or (h, w, c) uint8, c 3 or 4) through Pillow's libjpeg:
    stored in colour space ``space`` (from GRAY, RGB or CMYK input), with
    (h, v) sampling of each component in ``samp``, a scan script as
    tests/torch_jpeg_corpus.py's, ``adobe`` 0/1 to leave out or force the
    Adobe marker (-1: libjpeg's choice), and psv > 0 for a lossless frame
    (predictor psv, point transform pt)."""
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w = arr.shape[:2]
    comps = 1 if arr.ndim == 2 else arr.shape[2]
    in_space = {1: GRAY, 3: RGB, 4: CMYK}[comps]
    script, n = jcorpus._script(scans)
    lib = _writer()
    buf, size = ctypes.POINTER(ctypes.c_uint8)(), ctypes.c_ulong()
    if lib.pw_encode(jcorpus._u8p(arr), h, w, comps, in_space, space,
                     jcorpus._ints(samp), quality, int(progressive),
                     int(arithmetic), restart, script, n, adobe, psv, pt,
                     ctypes.byref(buf), ctypes.byref(size)):
        raise RuntimeError("libjpeg could not write the JPEG")
    try:
        return ctypes.string_at(buf, size.value)
    finally:
        lib.pw_free(buf)


def cmyk_samples(rgb: np.ndarray) -> np.ndarray:
    """(h, w, 4) samples as a CMYK JPEG stores them (Adobe's inverted
    convention, as Pillow reads them) for an RGB picture: k from the
    brightest channel, c, m, y the rest."""
    rgb = rgb.astype(np.int32)
    mx = rgb.max(-1, keepdims=True)
    k = 255 - mx
    cmy = (mx - rgb) * 255 // np.maximum(mx, 1)
    return (255 - np.concatenate([cmy, k], -1)).astype(np.uint8)


def patched(data: bytes, marker: int, offset: int, value: int) -> bytes:
    """data with one byte of the segment of its first marker set."""
    i = data.index(bytes([0xFF, marker]))
    out = bytearray(data)
    out[i + offset] = value
    return bytes(out)


def adobe_transform(data: bytes, value: int) -> bytes:
    i = data.index(b"Adobe")
    out = bytearray(data)
    out[i + 11] = value
    return bytes(out)


def sampled(data: bytes, factors) -> bytes:
    """A SOF3 file with the components' sampling bytes replaced."""
    i = data.index(b"\xff\xc3")
    out = bytearray(data)
    for c, hv in enumerate(factors):
        out[i + 11 + 3 * c] = hv
    return bytes(out)


def dc_only(v: int, h: int, w: int, seed: int) -> bytes:
    """A grey progressive file of one DC scan at Al 0 whose component is
    sampled 1 x v: every block smoothed from the 5x5 DC window, the iMCU
    rows v blocks tall."""
    return encode(jcorpus.picture(seed, h, w)[..., 0], GRAY, [1, v], 50,
                  scans=[((0,), 0, 0, 0, 0)])


# -- BMP ----------------------------------------------------------------------

def bmp(pixels: bytes, w: int, h: int, bits: int, header: int = 40,
        compression: int = 0, colors: int = 0, palette: bytes = b"",
        masks=(), offset=None, top_down: bool = False) -> bytes:
    """A BMP of raw pixel bytes (rows as stored) after an info header of
    ``header`` bytes (12: OS/2 core; 40, 108, 124); masks go into the
    header from 52 bytes on, else after it; offset None points past the
    palette."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                           1, bits, compression, len(pixels), 2835, 2835,
                           colors, 0)
        tail = struct.pack(f"<{len(masks)}I", *masks) if header > 40 else b""
        info += (tail + bytes(header))[:header - 40]
        if header == 40:
            info += struct.pack(f"<{len(masks)}I", *masks)
    start = 14 + len(info) + len(palette)
    off = start if offset is None else offset
    return b"BM" + struct.pack("<IHHI", start + len(pixels), 0, 0, off) + \
        info + palette + pixels


def bmp_rows(img: np.ndarray, bits: int, bottom_up: bool = True) -> bytes:
    """Rows of indices (bits 1, 4, 8: (h, w) uint8) or of BGR(X) bytes
    (bits 24, 32: (h, w, 3) RGB), padded to 4 bytes."""
    h, w = img.shape[:2]
    stride = ((w * bits + 31) >> 3) & ~3
    rows = []
    for y in (range(h - 1, -1, -1) if bottom_up else range(h)):
        r = img[y]
        if bits == 24:
            b = r[:, ::-1].tobytes()
        elif bits == 32:
            b = np.concatenate([r[:, ::-1], np.full((w, 1), 7, np.uint8)],
                               -1).tobytes()
        elif bits == 8:
            b = r.tobytes()
        else:
            b = np.packbits(np.unpackbits(r[:, None], axis=1)[:, 8 - bits:]
                            .reshape(-1)).tobytes()
        rows.append(b + bytes(stride - len(b)))
    return b"".join(rows)


def bgrx(rgb: np.ndarray) -> bytes:
    """A palette of 4-byte entries."""
    return np.concatenate([rgb[:, ::-1], np.zeros((len(rgb), 1), np.uint8)],
                          -1).astype(np.uint8).tobytes()


def rle8(img: np.ndarray) -> bytes:
    """(h, w) indices, bottom-up, as RLE8: runs of equal indices, absolute
    runs of the rest (padded to 16 bits), end of line, a delta over the
    first row's tail, end of bitmap."""
    h, w = img.shape
    out = bytearray()
    for n, y in enumerate(range(h - 1, -1, -1)):
        r = img[y].tolist()
        x = 0
        if n == 0 and w > 4:
            r = r[:w - 3]                      # the tail: a delta
        while x < len(r):
            run = 1
            while x + run < len(r) and r[x + run] == r[x] and run < 255:
                run += 1
            if run >= 3 or len(r) - x < 3:
                out += bytes([run, r[x]])
                x += run
            else:
                k = min(len(r) - x, 255)
                out += bytes([0, k, *r[x:x + k]]) + bytes(k % 2)
                x += k
        if n == 0 and w > 4:
            out += bytes([0, 2, 0, 0, 3, 0])   # Pillow skips two bytes first
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def rle4(img: np.ndarray) -> bytes:
    """(h, w) 4-bit indices, bottom-up, as RLE4: pairs of alternating
    indices as encoded runs; in every third row, absolute runs of four
    while four are left."""
    h, w = img.shape
    out = bytearray()
    for n, y in enumerate(range(h - 1, -1, -1)):
        r, x = img[y].tolist(), 0
        while n % 3 == 2 and x + 4 <= w:
            out += bytes([0, 4, r[x] << 4 | r[x + 1], r[x + 2] << 4 | r[x + 3]])
            x += 4
        for x in range(x, w, 2):
            pair = r[x:x + 2] + [0]
            out += bytes([min(2, w - x), pair[0] << 4 | pair[1]])
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


# -- GIF ----------------------------------------------------------------------

def lzw(indices, bits: int, clear_every: int = 0, end: bool = True) -> bytes:
    """LZW codes of ``indices`` at minimum code size ``bits``, packed LSB
    first: a clear code first, one every ``clear_every`` codes, the end
    code last (unless end is False)."""
    clear = 1 << bits
    codes, sizes = [], []
    table, nxt, size = {}, clear + 2, bits + 1

    def emit(c):
        codes.append(c)
        sizes.append(size)

    emit(clear)
    seq, i, count = list(indices), 0, 0
    while i < len(seq):
        cur = (seq[i],)
        i += 1
        while i < len(seq) and cur + (seq[i],) in table:
            cur += (seq[i],)
            i += 1
        emit(table[cur] if len(cur) > 1 else cur[0])
        count += 1
        if i < len(seq) and nxt < 4096:
            table[cur + (seq[i],)] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        if clear_every and count % clear_every == 0 and i < len(seq):
            emit(clear)
            table, nxt, size = {}, clear + 2, bits + 1
    if end:
        emit(clear + 1)
    acc = n = 0
    out = bytearray()
    for c, s in zip(codes, sizes):
        acc |= c << n
        n += s
        while n >= 8:
            out.append(acc & 255)
            acc >>= 8
            n -= 8
    if n:
        out.append(acc & 255)
    return bytes(out)


def sub_blocks(data: bytes, size: int = 255) -> bytes:
    out = bytearray()
    for i in range(0, len(data), size):
        out += bytes([len(data[i:i + size])]) + data[i:i + size]
    return bytes(out + b"\x00")


def table_bits(entries: int) -> int:
    return max(0, (entries - 1).bit_length() - 1)


def gif(indices: np.ndarray, screen=None, table=None, local=None,
        offset=(0, 0), interlace: bool = False, transparency=None,
        bits: int = 8, clear_every: int = 0, extensions: bytes = b"",
        data=None, end: bool = True) -> bytes:
    """A GIF of one frame of (h, w) indices: a global ``table`` and a
    ``local`` one ((n, 3) uint8, n a power of two, or None), a graphic
    control extension with ``transparency``, the frame at ``offset`` on a
    screen of ``screen`` (w, h), interlaced rows, LZW at minimum code size
    ``bits`` (or ``data``, raw sub-block bytes, in its place)."""
    h, w = indices.shape
    sw, sh = screen or (w, h)
    out = bytearray(b"GIF89a" + struct.pack("<HH", sw, sh))
    if table is not None:
        out += bytes([0x80 | table_bits(len(table)), 0, 0]) + \
            np.asarray(table, np.uint8).tobytes()
    else:
        out += b"\x00\x00\x00"
    out += extensions
    if transparency is not None:
        out += b"!\xf9\x04\x01\x00\x00" + bytes([transparency]) + b"\x00"
    flags = 0x40 if interlace else 0
    if local is not None:
        flags |= 0x80 | table_bits(len(local))
    out += b"," + struct.pack("<HHHH", *offset, w, h) + bytes([flags])
    if local is not None:
        out += np.asarray(local, np.uint8).tobytes()
    rows = indices
    if interlace:
        order = [*range(0, h, 8), *range(4, h, 8), *range(2, h, 4),
                 *range(1, h, 2)]
        rows = indices[order]
    out += bytes([bits])
    out += data if data is not None else sub_blocks(
        lzw(rows.reshape(-1).tolist(), bits, clear_every, end))
    return bytes(out + b";")


def quantized(rgb: np.ndarray, colors: int):
    """(indices, (colors, 3) table) of an RGB picture, by Pillow's
    median cut."""
    from PIL import Image

    im = Image.fromarray(rgb).quantize(colors)
    table = np.asarray(im.getpalette()[:3 * colors], np.uint8).reshape(-1, 3)
    return np.asarray(im), table


# -- the corpus ---------------------------------------------------------------

SAMPLINGS = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "440": (1, 2),
             "411": (4, 1)}


def _jpeg_cases(out: dict):
    p4 = cmyk_samples(jcorpus.picture(41, 53, 37))
    for name, (h, v) in SAMPLINGS.items():
        samp = [h, v, 1, 1, 1, 1, h, v]
        for space, tag in ((CMYK, "cmyk"), (YCCK, "ycck")):
            out[f"{tag}_{name}_37x53.jpg"] = encode(p4, space, samp, 85)
            out[f"{tag}_progressive_{name}_37x53.jpg"] = encode(
                p4, space, samp, 85, progressive=True)
    one = [1] * 8
    out["cmyk_no_adobe_37x53.jpg"] = encode(p4, CMYK, one, adobe=0)
    out["adobe_transform1_37x53.jpg"] = adobe_transform(
        encode(p4, YCCK, one), 1)
    out["cmyk_arith_37x53.jpg"] = encode(p4, CMYK, [2, 2, 1, 1, 1, 1, 2, 2],
                                         arithmetic=True)
    out["cmyk_restart3_37x53.jpg"] = encode(p4, YCCK, one, restart=3)
    out["cmyk_unrefined_37x53.jpg"] = encode(
        p4, CMYK, [2, 2, 1, 1, 1, 1, 1, 1],
        scans=[((0, 1, 2, 3), 0, 0, 0, 0)] +
        [((c,), 1, 63, 0, 1) for c in range(4)])
    cut = encode(jcorpus.picture(42, 64, 96, 4), CMYK, one, 85)
    out["cmyk_cut_96x64.jpg"] = cut[:len(cut) // 2]
    # lossless
    p = jcorpus.picture(43, 53, 37)
    for psv in range(1, 8):
        out[f"lossless_psv{psv}_37x53.jpg"] = encode(p, RGB, [1] * 6,
                                                     psv=psv)
    out["lossless_pt2_37x53.jpg"] = encode(p, RGB, [1] * 6, psv=6, pt=2)
    out["lossless_gray_37x53.jpg"] = encode(p[..., 0], GRAY, [1, 1], psv=4)
    out["lossless_cmyk_37x53.jpg"] = encode(p4, CMYK, one, psv=5)
    out["lossless_restart_37x53.jpg"] = encode(p, RGB, [1] * 6, psv=7,
                                               restart=2 * 37)
    out["lossless_scans_37x53.jpg"] = encode(
        p, RGB, [1] * 6, psv=2, scans=[((c,), 2, 0, 0, 1) for c in range(3)])
    out["lossless_patched_420_37x53.jpg"] = sampled(
        encode(p, RGB, [1] * 6, psv=1), [0x22, 0x11, 0x11])
    x, y = np.meshgrid(np.arange(256), np.arange(256))
    pairs = np.stack([x, 255 - x, x * 7 % 256, y], -1).astype(np.uint8)
    out["cmyk_all_pairs_256x256.jpg"] = encode(pairs, CMYK, one, psv=1)
    refused = encode(p, RGB, [1] * 6, psv=1)
    out["lossless_ycc_37x53.jpg"] = adobe_transform(refused, 1)
    out["lossless_sof11_37x53.jpg"] = patched(refused, 0xC3, 1, 0xCB)
    out["lossless_cut_37x53.jpg"] = refused[:len(refused) * 2 // 3]
    scans = encode(p, RGB, [1] * 6, psv=1,
                   scans=[((c,), 1, 0, 0, 0) for c in range(3)])
    second = [i for i in range(len(scans)) if scans[i:i + 2] == b"\xff\xda"]
    out["lossless_missing_scan_37x53.jpg"] = scans[:second[1]] + b"\xff\xd9"
    # libjpeg-turbo 3.1's smoothing window
    out["smooth_second_row_40x37.jpg"] = dc_only(2, 37, 40, 44)
    out["smooth_last_second_40x31.jpg"] = dc_only(3, 31, 40, 45)
    out["smooth_padded_rows_40x56.jpg"] = dc_only(3, 56, 40, 46)
    out["smooth_narrow_10x31.jpg"] = dc_only(1, 31, 10, 47)
    out["smooth_last_row_40x40.jpg"] = dc_only(4, 40, 40, 48)
    # tests/torch_jpeg_corpus.py's scene recoded with AC bands never
    # refined: 2514 values apart between the two libjpegs' smoothing
    with open(os.path.join(jcorpus.FOLDER, "scene_unrefined_640x480.jpg"),
              "rb") as f:
        out["smooth_scene_unrefined_640x480.jpg"] = f.read()


def _bmp_cases(out: dict):
    rng = np.random.default_rng(50)
    rgb = jcorpus.picture(51, 53, 37)
    idx, table = quantized(rgb, 256)
    out["bmp_24_37x53.bmp"] = bmp(bmp_rows(rgb, 24), 37, 53, 24)
    out["bmp_24_topdown_37x53.bmp"] = bmp(bmp_rows(rgb, 24, False), 37, 53,
                                          24, top_down=True)
    out["bmp_32_37x53.bmp"] = bmp(bmp_rows(rgb, 32), 37, 53, 32)
    out["bmp_8_37x53.bmp"] = bmp(bmp_rows(idx, 8), 37, 53, 8,
                                 palette=bgrx(table))
    short = (idx % 40).astype(np.uint8)
    out["bmp_8_short_palette_37x53.bmp"] = bmp(
        bmp_rows(short, 8), 37, 53, 8, colors=20, palette=bgrx(table[:20]))
    i16, t16 = quantized(rgb, 16)
    out["bmp_4_37x53.bmp"] = bmp(bmp_rows(i16, 4), 37, 53, 4,
                                 palette=bgrx(t16))
    i2 = (rgb[..., 0] > 127).astype(np.uint8)
    out["bmp_1_37x53.bmp"] = bmp(bmp_rows(i2, 1), 37, 53, 1,
                                 palette=bgrx(np.array([[200, 30, 30],
                                                        [20, 40, 220]])))
    out["bmp_1_gray_37x53.bmp"] = bmp(bmp_rows(i2, 1), 37, 53, 1,
                                      palette=bgrx(np.array([[0] * 3,
                                                             [255] * 3])))
    gray = rgb[..., 1]
    out["bmp_8_gray_37x53.bmp"] = bmp(
        bmp_rows(gray, 8), 37, 53, 8,
        palette=bgrx(np.repeat(np.arange(256)[:, None], 3, 1)))
    out["bmp_os2_24_37x53.bmp"] = bmp(bmp_rows(rgb, 24), 37, 53, 24,
                                      header=12)
    out["bmp_os2_8_37x53.bmp"] = bmp(bmp_rows(idx, 8), 37, 53, 8, header=12,
                                     palette=table.astype(np.uint8)[:, ::-1]
                                     .tobytes())
    out["bmp_offset_after_header_37x53.bmp"] = bmp(
        bmp_rows(i16, 4), 37, 53, 4, colors=16, palette=bgrx(t16),
        offset=14 + 40)
    words = rng.integers(0, 65536, (53, 37), np.uint16)
    rows16 = bmp_rows(words.view(np.uint8).reshape(53, 74), 8)
    out["bmp_16_555_37x53.bmp"] = bmp(rows16, 37, 53, 16)
    out["bmp_16_565_37x53.bmp"] = bmp(rows16, 37, 53, 16, compression=3,
                                      masks=(0xF800, 0x7E0, 0x1F))
    rows32 = bmp_rows(rng.integers(0, 256, (53, 148), np.uint8), 8)
    for tag, masks, header in (
            ("bgrx", (0xFF0000, 0xFF00, 0xFF), 40),
            ("xbgr", (0xFF000000, 0xFF0000, 0xFF00, 0), 108),
            ("bgxr", (0xFF000000, 0xFF00, 0xFF, 0), 124),
            ("rgba", (0xFF, 0xFF00, 0xFF0000, 0xFF000000), 124),
            ("bgar", (0xFF000000, 0xFF00, 0xFF, 0xFF0000), 108)):
        out[f"bmp_32_bitfields_{tag}_37x53.bmp"] = bmp(
            rows32, 37, 53, 32, header=header, compression=3, masks=masks)
    out["bmp_v4_24_37x53.bmp"] = bmp(bmp_rows(rgb, 24), 37, 53, 24,
                                     header=108)
    out["bmp_v5_8_37x53.bmp"] = bmp(bmp_rows(idx, 8), 37, 53, 8, header=124,
                                    palette=bgrx(table))
    blocky = np.repeat(idx[:, ::4], 4, 1)[:, :37]
    out["bmp_rle8_37x53.bmp"] = bmp(rle8(blocky), 37, 53, 8, compression=1,
                                    palette=bgrx(table))
    out["bmp_rle4_37x53.bmp"] = bmp(rle4(i16), 37, 53, 4, compression=2,
                                    palette=bgrx(t16))
    # refused
    out["bmp_bits2_37x53.bmp"] = bmp(bmp_rows(i2, 8), 37, 53, 2)
    out["bmp_jpeg_compression_37x53.bmp"] = bmp(bmp_rows(rgb, 24), 37, 53,
                                                24, compression=4)
    out["bmp_bad_bitfields_37x53.bmp"] = bmp(rows32, 37, 53, 32,
                                             compression=3,
                                             masks=(0xF00, 0xF0, 0xF))
    out["bmp_palette_300_37x53.bmp"] = bmp(
        bmp_rows(idx, 8), 37, 53, 8, colors=300,
        palette=bgrx(np.resize(table, (300, 3))))
    whole = bmp(bmp_rows(rgb, 24), 37, 53, 24)
    out["bmp_cut_37x53.bmp"] = whole[:len(whole) - 200]
    out["bmp_rle_short_37x53.bmp"] = bmp(rle8(blocky)[:300] + b"\x00\x01",
                                         37, 53, 8, compression=1,
                                         palette=bgrx(table))


def _gif_cases(out: dict):
    rgb = jcorpus.picture(61, 53, 37)
    idx, table = quantized(rgb, 256)
    i16, t16 = quantized(rgb, 16)
    ramp = np.repeat(np.arange(16, dtype=np.uint8)[:, None], 3, 1)
    out["gif_global_37x53.gif"] = gif(idx, table=table)
    out["gif_local_37x53.gif"] = gif(i16, local=t16, bits=4)
    out["gif_gray_local_over_global_37x53.gif"] = gif(i16, table=t16[::-1],
                                                      local=ramp, bits=4)
    out["gif_no_table_37x53.gif"] = gif(idx)
    out["gif_interlaced_37x53.gif"] = gif(idx, table=table, interlace=True)
    out["gif_offset_transparency_37x53.gif"] = gif(
        i16[10:40, 5:30], screen=(37, 53), table=t16, offset=(5, 10),
        transparency=9, bits=4)
    out["gif_transparency_37x53.gif"] = gif(idx, table=table,
                                            transparency=3)
    out["gif_grow_37x53.gif"] = gif(i16[:40, :30], screen=(20, 20),
                                    table=t16, offset=(7, 13), bits=4)
    i4 = (i16 % 4).astype(np.uint8)
    out["gif_codesize2_37x53.gif"] = gif(i4, table=t16[:4], bits=2)
    out["gif_clears_37x53.gif"] = gif(idx, table=table, clear_every=17)
    noise = np.random.default_rng(62).integers(0, 256, (96, 96), np.uint8)
    out["gif_table_full_96x96.gif"] = gif(noise, table=table)
    out["gif_extensions_37x53.gif"] = gif(
        i16, table=t16, bits=4,
        extensions=b"!\xfe" + sub_blocks(b"made by a test " * 30, 100) +
        b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00" + b"\x00\x07")
    out["gif_short_table_37x53.gif"] = gif(i16, table=t16[:2], bits=4)
    # refused
    whole = gif(idx, table=table)
    out["gif_cut_37x53.gif"] = whole[:len(whole) * 3 // 4]
    out["gif_early_end_37x53.gif"] = gif(
        idx, table=table, data=sub_blocks(lzw(idx.reshape(-1)[:900].tolist(),
                                              8)))
    out["gif_bad_code_37x53.gif"] = gif(
        idx, table=table, data=sub_blocks(bytes([0, 1, 0xFF, 0xFF, 0xFF])))
    out["gif_no_image_37x53.gif"] = whole[:13 + 768] + b";"
    out["gif_codesize13_37x53.gif"] = gif(idx, table=table, bits=13,
                                          data=sub_blocks(lzw(
                                              idx.reshape(-1).tolist(), 8)))


def scene_cases() -> dict:
    """The 640x480 scene in each format."""
    rgb = torch_jpeg_fixtures.scene(0)
    s4 = cmyk_samples(rgb)
    idx, table = quantized(rgb, 256)
    i64, t64 = quantized(rgb, 64)
    return {
        "scene_cmyk_640x480.jpg": encode(s4, CMYK, [1] * 8, 85),
        "scene_ycck_640x480.jpg": encode(s4, YCCK, [2, 2, 1, 1, 1, 1, 2, 2],
                                         85),
        "scene_lossless_640x480.jpg": encode(rgb, RGB, [1] * 6, psv=7),
        "scene_640x480.bmp": bmp(bmp_rows(idx, 8), 640, 480, 8,
                                 palette=bgrx(table)),
        "scene_640x480.gif": gif(i64, table=t64, bits=6),
    }


def cases() -> dict:
    """{file name: bytes}."""
    out = {}
    _jpeg_cases(out)
    _bmp_cases(out)
    _gif_cases(out)
    out.update(scene_cases())
    return out


def digest(img) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def pillow_decode(data: bytes):
    """Image.open(...).convert("RGB") of data (detect --img in JAX), or
    None where Pillow fails."""
    from PIL import Image

    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))
    except Exception:
        return None


def pillow_size(data: bytes):
    """[h, w] as Pillow's open reads them, or None."""
    from PIL import Image

    try:
        with Image.open(io.BytesIO(data)) as im:
            return [im.size[1], im.size[0]]
    except Exception:
        return None


def reference(data: bytes) -> dict:
    """Each JAX route's pixels' sha256 (null where it fails) and the
    size Pillow reads."""
    from yolov5m_tpu.serving.server import _decode_image

    loader, img = _decode_image(data), pillow_decode(data)
    return {"loader": None if loader is None else digest(loader),
            "img": None if img is None else digest(img),
            "hw": pillow_size(data)}


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
