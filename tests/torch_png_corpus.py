"""The PNG corpus of the port's decoder (tests/fixtures/torch_png_corpus/).

Small files written from numpy seeds by this module's own writer (``encode``:
any bit depth and colour type, Adam7 interlace, a chosen filter type for
each row, the image stream split over several IDAT chunks, ancillary chunks,
CRCs given by hand), one for each case the port's decoder
(yolov5m_tpu_torch/csrc/png_decode.cc) must take as Pillow takes it:

- grey at 1, 2, 4, 8 and 16 bits (16-bit values above 255 too), RGB and
  RGBA at 8 and 16 bits, grey with alpha at 8 and 16 bits, palettes at 1, 2,
  4 and 8 bits (one shorter than its indices, one with tRNS), grey and RGB
  with tRNS;
- each of them Adam7-interlaced, and interlaced images of 1x1 to 9x7,
  whose first passes are empty;
- every filter type alone, and rows cycling through all five;
- the image stream in 1-byte IDAT chunks, in chunks of uneven sizes, with
  an empty IDAT among them, and compressed at levels 0 and 9;
- ancillary chunks before and after the image data, an unknown critical
  chunk, data after IEND, a stream longer than the image needs;
- files Pillow still decodes: cut after the image data (before IDAT's CRC,
  inside IEND), without IEND, a bad CRC on IDAT or on a chunk after it, a
  bad Adler-32 that Pillow's loader never reads (after rows the image does
  not need, or alone in the last IDAT);
- files Pillow refuses: cut inside IHDR, inside a chunk before the image
  data, in the image stream, between two IDATs; a bad CRC on IHDR, PLTE or
  a chunk before the image data; a broken deflate stream, a bad Adler-32
  read with the last rows, a filter type of 5, a chunk type that is not
  one, no IHDR, a bit depth Pillow does not know, IEND before the image
  data, an empty image;
- one 640x480 scene (tests/torch_jpeg_fixtures.py:scene 0) with rows
  cycling through the five filters.

``digests.json`` holds, for each file, the sha256 of Pillow's
``np.asarray(Image.open(f).convert("RGB"))`` and the (h, w) that Pillow's
open reads, each null where Pillow fails. ``chip_smoke.py`` holds the
port's decoder to those digests on a machine without Pillow. Remake the
corpus (Pillow needed) with

  python -m tests.torch_png_corpus [folder]

File names give the width before the height.
"""

import hashlib
import io
import json
import os
import struct
import sys
import warnings
import zlib

import numpy as np

FOLDER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                      "torch_png_corpus")
DIGESTS = "digests.json"
SIGNATURE = b"\x89PNG\r\n\x1a\n"

# samples a pixel, by colour type
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7: (x0, y0, dx, dy) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def chunk(cid: bytes, data: bytes, crc: int = None) -> bytes:
    """One chunk; crc: a CRC to write instead of the right one."""
    if crc is None:
        crc = zlib.crc32(cid + data)
    return struct.pack(">I", len(data)) + cid + data + struct.pack(">I", crc)


def pack_row(row: np.ndarray, depth: int) -> bytes:
    """One row of samples (w * channels,) at depth bits, big-endian and
    most significant bits first."""
    row = np.asarray(row).astype(np.int64).ravel()
    if depth == 16:
        return row.astype(">u2").tobytes()
    if depth == 8:
        return row.astype(np.uint8).tobytes()
    per = 8 // depth
    pad = (-len(row)) % per
    row = np.concatenate([row, np.zeros(pad, np.int64)]).reshape(-1, per)
    shifts = depth * np.arange(per - 1, -1, -1)
    return (row << shifts).sum(1).astype(np.uint8).tobytes()


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def filter_row(row: bytes, prev: bytes, ftype: int, bpp: int) -> bytes:
    """Filter one packed row against the packed row above it."""
    r = np.frombuffer(row, np.uint8).astype(np.int64)
    p = np.frombuffer(prev, np.uint8).astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])[:len(r)]
    upleft = np.concatenate([np.zeros(bpp, np.int64), p[:-bpp]])[:len(r)]
    if ftype == 0:
        out = r
    elif ftype == 1:
        out = r - left
    elif ftype == 2:
        out = r - p
    elif ftype == 3:
        out = r - (left + p) // 2
    elif ftype == 4:
        out = r - np.array([_paeth(a, b, c) for a, b, c
                            in zip(left, p, upleft)], np.int64)
    else:           # an unknown type: the row as it is
        out = r
    return bytes([ftype]) + (out & 0xFF).astype(np.uint8).tobytes()


def scanlines(samples: np.ndarray, depth: int, filters=(0, 1, 2, 3, 4),
              interlace: bool = False) -> bytes:
    """The filtered scanlines of (h, w, channels) samples; row k of the
    file takes filter type filters[k % len(filters)]."""
    cn = samples.shape[2]
    bpp = max(1, depth * cn // 8)
    images = [samples] if not interlace else [
        samples[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7]
    out, k = [], 0
    for img in images:
        if img.shape[0] == 0 or img.shape[1] == 0:
            continue
        prev = bytes(len(pack_row(img[0], depth)))
        for row in img:
            packed = pack_row(row, depth)
            out.append(filter_row(packed, prev, filters[k % len(filters)],
                                  bpp))
            prev, k = packed, k + 1
    return b"".join(out)


def encode(samples: np.ndarray, depth: int = 8, ctype: int = 2,
           interlace: bool = False, filters=(0, 1, 2, 3, 4),
           level: int = 6, idat_sizes=None, palette: bytes = None,
           trns: bytes = None, before=(), after=(), stream: bytes = None,
           ihdr: bytes = None, end: bytes = None) -> bytes:
    """A PNG of samples (h, w, channels) at depth bits and colour type
    ctype. idat_sizes: the image stream's split into IDAT chunks (cycled;
    0 writes an empty chunk); before/after: chunks written before and after
    the image data; stream: the compressed stream to write instead;
    ihdr: the IHDR data to write instead; end: what to write for IEND."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, _ = samples.shape
    if ihdr is None:
        ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                           int(interlace))
    if stream is None:
        stream = zlib.compress(scanlines(samples, depth, filters, interlace),
                               level)
    out = [SIGNATURE, chunk(b"IHDR", ihdr), *before]
    if palette is not None:
        out.append(chunk(b"PLTE", palette))
    if trns is not None:
        out.append(chunk(b"tRNS", trns))
    if idat_sizes is None:
        out.append(chunk(b"IDAT", stream))
    else:
        pos, i = 0, 0
        while pos < len(stream):
            n = idat_sizes[i % len(idat_sizes)]
            out.append(chunk(b"IDAT", stream[pos:pos + n]))
            pos, i = pos + n, i + 1
    out.extend(after)
    out.append(chunk(b"IEND", b"") if end is None else end)
    return b"".join(out)


def samples(seed: int, h: int, w: int, cn: int, depth: int) -> np.ndarray:
    """(h, w, cn) samples below 2^depth: smooth ramps with noise, so that
    every filter has work and the stream compresses."""
    rng = np.random.default_rng(seed)
    top = (1 << depth) - 1
    y, x = np.mgrid[0:h, 0:w]
    ramp = (x / max(w - 1, 1) + y / max(h - 1, 1)) / 2
    base = ramp[..., None] * top * (0.3 + 0.7 * rng.random(cn))
    noise = rng.normal(0, 0.08 * top + 0.6, (h, w, cn))
    return np.clip(np.round(base + noise), 0, top).astype(np.int64)


def _find(data: bytes, cid: bytes, after: bytes = None) -> tuple:
    """(offset, offset of the CRC) of the first chunk of type cid (the
    first after the first chunk of type after, where given)."""
    start = data.index(cid, data.index(after) if after else 8) - 4
    length = struct.unpack(">I", data[start:start + 4])[0]
    return start, start + 8 + length


def _cut_at(data: bytes, cid: bytes, offset: int) -> bytes:
    """data cut offset bytes into its first chunk of type cid."""
    return data[:_find(data, cid)[0] + offset]


def _bad_crc(data: bytes, cid: bytes, after: bytes = None) -> bytes:
    """data with the CRC of a chunk of type cid inverted (see _find)."""
    end = _find(data, cid, after)[1]
    crc = struct.unpack(">I", data[end:end + 4])[0] ^ 0xFFFFFFFF
    return data[:end] + struct.pack(">I", crc) + data[end + 4:]


def cases() -> dict:
    """{file name: PNG bytes}."""
    out = {}
    w, h = 37, 53
    text = chunk(b"tEXt", b"Comment\x00made from a numpy seed")
    # every colour type and bit depth, plain and interlaced
    modes = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
             (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
    for k, (ctype, depth) in enumerate(modes):
        s = samples(10 + k, h, w, CHANNELS[ctype], depth)
        palette = None
        if ctype == 3:
            n = 1 << depth
            palette = np.random.default_rng(k).integers(
                0, 256, 3 * n, np.uint8).tobytes()
        for interlace in (False, True):
            name = f"type{ctype}_{depth}bit{'_adam7' if interlace else ''}"
            out[f"{name}_{w}x{h}.png"] = encode(
                s, depth, ctype, interlace, palette=palette)
    # 16-bit grey over the whole range: Pillow clamps at 255
    wide = np.random.default_rng(30).integers(0, 65536, (9, 11, 1))
    wide[0, :4, 0] = (0, 255, 256, 65535)
    out["type0_16bit_wide_11x9.png"] = encode(wide, 16, 0)
    # palettes: shorter than the indices (they read black), with tRNS
    idx = np.random.default_rng(31).integers(0, 16, (12, 13, 1))
    out["palette_short_13x12.png"] = encode(
        idx, 4, 3, palette=bytes(range(30)))
    out["palette_trns_13x12.png"] = encode(
        idx, 4, 3, palette=bytes(range(48)), trns=bytes([0, 128, 255, 7]))
    out["palette_trns_simple_13x12.png"] = encode(
        idx, 4, 3, palette=bytes(range(48)), trns=b"\xff\xff\x00")
    out["type0_trns_13x12.png"] = encode(
        samples(32, 12, 13, 1, 8), 8, 0, trns=b"\x00\x10")
    out["type2_trns_13x12.png"] = encode(
        samples(33, 12, 13, 3, 8), 8, 2, trns=b"\x00\x10\x00\x20\x00\x30")
    # tiny interlaced images: empty passes
    for tw, th in ((1, 1), (2, 1), (1, 3), (3, 5), (5, 3), (9, 7)):
        out[f"adam7_tiny_{tw}x{th}.png"] = encode(
            samples(40 + tw * 10 + th, th, tw, 3, 8), 8, 2, True)
        out[f"adam7_tiny_2bit_{tw}x{th}.png"] = encode(
            samples(60 + tw * 10 + th, th, tw, 1, 2), 2, 0, True)
    # filters
    rgb = samples(70, 24, 31, 3, 8)
    for f in range(5):
        out[f"filter{f}_31x24.png"] = encode(rgb, 8, 2, filters=(f,))
        out[f"filter{f}_16bit_31x24.png"] = encode(
            samples(71, 24, 31, 4, 16), 16, 6, filters=(f,))
        out[f"filter{f}_1bit_31x24.png"] = encode(
            samples(72, 24, 31, 1, 1), 1, 0, filters=(f,))
    # the stream over several chunks, compression levels
    out["idat_bytes_31x24.png"] = encode(rgb, idat_sizes=(1,))
    out["idat_uneven_31x24.png"] = encode(rgb, idat_sizes=(7, 0, 100, 3))
    out["level0_31x24.png"] = encode(rgb, level=0)
    out["level9_31x24.png"] = encode(rgb, level=9)
    # ancillary and unknown chunks, data after IEND, a longer stream
    out["chunks_31x24.png"] = encode(
        rgb, before=(text, chunk(b"gAMA", struct.pack(">I", 45455)),
                     chunk(b"pHYs", struct.pack(">IIB", 2835, 2835, 1))),
        after=(text,))
    out["unknown_critical_31x24.png"] = encode(
        rgb, before=(chunk(b"ABCD", b"not known"),))
    out["after_iend_31x24.png"] = encode(rgb) + b"trailing bytes"
    extra = zlib.compress(scanlines(rgb, 8) + bytes(500))
    out["long_stream_31x24.png"] = encode(rgb, stream=extra)
    # a bad Adler-32 where the image is whole before it is read: after
    # rows the image does not need, or alone in the last IDAT
    out["long_stream_bad_adler_31x24.png"] = encode(
        rgb, stream=extra[:-1] + bytes([extra[-1] ^ 1]))
    stream = zlib.compress(scanlines(rgb, 8))
    stream = stream[:-1] + bytes([stream[-1] ^ 1])
    out["bad_adler_own_idat_31x24.png"] = encode(
        rgb, stream=stream, idat_sizes=(len(stream) - 4, 4))
    # decoded by Pillow although broken
    good = encode(rgb, before=(text,), after=(text,))
    out["cut_before_idat_crc_31x24.png"] = good[:_find(good, b"IDAT")[1]]
    out["cut_in_iend_31x24.png"] = good[:-6]
    out["no_iend_31x24.png"] = good[:-12]
    out["bad_crc_idat_31x24.png"] = _bad_crc(good, b"IDAT")
    out["bad_crc_after_idat_31x24.png"] = _bad_crc(good, b"tEXt", b"IDAT")
    out["bad_crc_iend_31x24.png"] = _bad_crc(good, b"IEND")
    # refused by Pillow
    out["cut_in_ihdr.png"] = good[:20]
    out["cut_in_text_31x24.png"] = _cut_at(good, b"tEXt", 14)
    out["cut_in_stream_31x24.png"] = _cut_at(good, b"IDAT", 60)
    split = encode(rgb, idat_sizes=(40,))
    out["cut_between_idats_31x24.png"] = split[:_find(split, b"IDAT",
                                                      b"IDAT")[1] + 4]
    out["bad_crc_ihdr_31x24.png"] = _bad_crc(good, b"IHDR")
    out["bad_crc_text_31x24.png"] = _bad_crc(good, b"tEXt")
    out["bad_crc_plte_13x12.png"] = _bad_crc(
        out["palette_trns_13x12.png"], b"PLTE")
    stream = bytearray(zlib.compress(scanlines(rgb, 8)))
    stream[len(stream) // 2] ^= 0xFF
    out["broken_stream_31x24.png"] = encode(rgb, stream=bytes(stream))
    stream = bytearray(zlib.compress(scanlines(rgb, 8)))
    stream[-1] ^= 0x01
    out["bad_adler_31x24.png"] = encode(rgb, stream=bytes(stream))
    out["filter5_31x24.png"] = encode(rgb, filters=(0, 1, 5))
    out["bad_chunk_type_31x24.png"] = encode(
        rgb, before=(chunk(b"tE!t", b"x"),))
    out["no_ihdr_31x24.png"] = good.replace(b"IHDR", b"iHDR", 1)
    out["depth3_31x24.png"] = encode(
        rgb, ihdr=struct.pack(">IIBBBBB", 31, 24, 3, 2, 0, 0, 0))
    out["iend_first_31x24.png"] = SIGNATURE + chunk(
        b"IHDR", struct.pack(">IIBBBBB", 31, 24, 8, 2, 0, 0, 0)) + \
        chunk(b"IEND", b"") + good[good.index(b"IDAT") - 4:]
    out["empty_0x24.png"] = encode(np.zeros((24, 0, 3), np.int64))
    # the flagship-size scene
    from tests.torch_jpeg_fixtures import scene
    out["scene_640x480.png"] = encode(scene(0), 8, 2)
    return out


def pillow(data: bytes) -> dict:
    """Pillow's decode of data: the sha256 of np.asarray(convert("RGB"))
    and the (h, w) its open reads, each None where it fails."""
    from PIL import Image

    hw = img = None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            with Image.open(io.BytesIO(data)) as im:
                hw = [im.size[1], im.size[0]]
                img = np.asarray(im.convert("RGB"))
        except Exception:  # Pillow raises many types on broken files
            pass
    return {"sha256": None if img is None else digest(img), "hw": hw}


def digest(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def load(folder: str = FOLDER) -> dict:
    """{file name: {"sha256": ..., "hw": [h, w]}} of digests.json."""
    with open(os.path.join(folder, DIGESTS)) as f:
        return json.load(f)


def write(folder: str = FOLDER) -> dict:
    """Write every case and digests.json into folder; returns the digests."""
    os.makedirs(folder, exist_ok=True)
    digests = {}
    for name, data in sorted(cases().items()):
        with open(os.path.join(folder, name), "wb") as f:
            f.write(data)
        digests[name] = pillow(data)
    with open(os.path.join(folder, DIGESTS), "w") as f:
        f.write("{\n" + ",\n".join(
            f" {json.dumps(k)}: {json.dumps(v, sort_keys=True)}"
            for k, v in digests.items()) + "\n}\n")
    return digests


if __name__ == "__main__":
    print(json.dumps(write(*sys.argv[1:]), indent=1, sort_keys=True))
