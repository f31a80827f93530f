"""The ZSTD and LZMA TIFF corpus (tests/fixtures/torch_tiff_zstd_lzma_corpus/):
files the JAX package hands to Pillow 12.1.0, whose TiffImagePlugin reads
them over libtiff 4.7.1 (ZSTDDecode over libzstd 1.5.7, LZMADecode over
liblzma 5.8.2, TIFFRGBAImage for YCbCr), and which the port reads in
data/tiff.py, csrc/zstd_decode.cc and csrc/xz_decode.cc.

Small files made from numpy seeds, from four sources:

- tests/torch_tiff_writer.c over Pillow's libtiff: strips, tiles and
  planes, predictors 2 and 3 at 8, 16 and 32 bits and in floats,
  big-endian, BigTIFF, fill order 2, Orientation 1-8, ZSTD levels and
  LZMA presets;
- Pillow's writer (``compression="zstd"`` and ``"lzma"``) in its modes;
- strips written here (``tiff_file``) around frames and streams made
  through ctypes with the bundled libraries (``zstd_frame``,
  ``xz_stream``): every finding of the probe of libtiff's loops (a frame
  that ends before the strip is full, a skippable frame first, bytes past
  a full frame, a frame longer than the strip, a bad checksum, a frame
  without a content size, a frame cut by its last four bytes, a byte
  flipped and kept; a corrupt index, a bad CRC32, a flipped byte whose
  fault comes after the output is full, two streams, an .lzma strip),
  zstd levels -5 to 22, checksums, window logs, long-distance matching,
  a dictionary ID, legacy magic, xz checks (an unsupported one among
  them), every filter chain liblzma decodes, presets 0-9 and 9e, a
  dictionary smaller than the strip; YCbCr (TIFFRGBAImage) with a faulty
  second strip, where the refused strip's bytes show; WebP in TIFF
  (50001), which Pillow's libtiff is built without;
- the 640x480 scene (tests/torch_jpeg_fixtures.py:scene 0) for
  chip_smoke.py's phase 9n, written by libtiff at its default ZSTD level
  (also under Orientation 6), with ZSTD and predictor 2, with LZMA preset
  6 and predictor 2, and as YCbCr 2x2 under ZSTD (packed here, each strip
  streamed through libzstd as libtiff's ZSTDEncode streams it): the card
  has no encoder the port may rely on, so these are committed.

``digests.json`` holds, for each file, each JAX route's pixels' sha256
(tests/torch_tiff_corpus.py:reference; null where the route fails) and
the size Pillow reads. Remake the corpus (Pillow, the JAX package, g++
with the system's tiffio.h for the writer) with

  python -m tests.torch_tiff_zstd_lzma_corpus [folder]

``zstd_libtiff`` and ``lzma_libtiff`` drive the bundled libraries as
libtiff's loops drive them, zeroing a refused chunk past the output
position the library reports as libtiff does (the tests hold the port's
C alone against them). File names give the width before the height.
"""

import ctypes
import functools
import glob
import json
import os
import struct
import sys

import numpy as np


def _sibling(name: str):
    """tests/{name}.py by its path (chip_smoke.py loads this module so: a
    package named "tests" elsewhere on sys.path must not shadow it)."""
    import importlib.util

    if f"tests.{name}" in sys.modules:
        return sys.modules[f"tests.{name}"]
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


tc = _sibling("torch_tiff_corpus")
tj = _sibling("torch_tiff_jpeg_corpus")

FOLDER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                      "torch_tiff_zstd_lzma_corpus")
DIGESTS = "digests.json"
# the scenes chip_smoke.py's phase 9n reads (their PPM twins are made there)
SCENES = ("scene_zstd_640x480.tif", "scene_zstd_pred2_640x480.tif",
          "scene_lzma_p6_pred2_640x480.tif",
          "scene_ycbcr22_zstd_640x480.tif")
# detect --img's file there: the ZSTD scene under Orientation 6
ROTATED = "scene_zstd_orient6_640x480.tif"
# the probe's findings: file -> Pillow keeps the image
FINDINGS = {
    "z_two_frames_first_short_19x13.tif": False,
    "z_skippable_first_19x13.tif": False,
    "z_bytes_after_full_frame_19x13.tif": True,
    "z_frame_longer_than_strip_19x13.tif": True,
    "z_longer_bad_checksum_19x13.tif": True,
    "z_bad_checksum_19x13.tif": False,
    "z_no_content_size_19x13.tif": True,
    "z_cut_last4_19x13.tif": False,
    "z_flipped_kept_l19_a_37x29.tif": True,
    "x_delta_19x13.tif": True,
    "x_x86_19x13.tif": True,
    "x_preset9e_19x13.tif": True,
    "x_check_none_19x13.tif": True,
    "x_check_sha256_19x13.tif": True,
    "x_corrupt_index_19x13.tif": True,
    "x_bad_crc32_19x13.tif": True,
    "x_flipped_kept_19x13.tif": True,
    "x_two_streams_first_short_19x13.tif": False,
    "x_lzma_alone_19x13.tif": False,
}


# -- the bundled libraries, through ctypes ------------------------------------

def _pillow_lib(stem: str) -> str:
    import PIL

    found = glob.glob(os.path.join(os.path.dirname(os.path.dirname(
        PIL.__file__)), "pillow.libs", f"{stem}-*.so*"))
    if not found:
        raise RuntimeError(f"Pillow bundles no {stem} here")
    return found[0]


class _Buf(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


@functools.cache
def libzstd():
    """Pillow's libzstd 1.5.7."""
    z = ctypes.CDLL(_pillow_lib("libzstd"))
    vp, sz = ctypes.c_void_p, ctypes.c_size_t
    for name, res, args in [
            ("ZSTD_createDStream", vp, []),
            ("ZSTD_freeDStream", sz, [vp]), ("ZSTD_initDStream", sz, [vp]),
            ("ZSTD_decompressStream", sz, [vp, vp, vp]),
            ("ZSTD_isError", ctypes.c_uint, [sz]),
            ("ZSTD_getErrorName", ctypes.c_char_p, [sz]),
            ("ZSTD_createCCtx", vp, []), ("ZSTD_freeCCtx", sz, [vp]),
            ("ZSTD_CCtx_setParameter", sz, [vp, ctypes.c_int, ctypes.c_int]),
            ("ZSTD_compressStream2", sz, [vp, vp, vp, ctypes.c_int]),
            ("ZSTD_compress2", sz, [vp, vp, sz, vp, sz]),
            ("ZSTD_compressBound", sz, [sz])]:
        f = getattr(z, name)
        f.restype = res
        f.argtypes = args
    return z


def zstd_libtiff(chunk: bytes, occ: int, fill: int = 0):
    """libtiff's ZSTDDecode of a chunk into occ bytes (filled with fill):
    ZSTD_decompressStream until a frame ends, an error, the output full or
    the input spent; a refused chunk zeroed past the output position.
    (kept, the buffer, an error name or None)."""
    z = libzstd()
    ds = z.ZSTD_createDStream()
    z.ZSTD_initDStream(ds)
    src = ctypes.create_string_buffer(bytes(chunk), max(1, len(chunk)))
    dst = ctypes.create_string_buffer(bytes([fill]) * occ, max(1, occ))
    ib = _Buf(ctypes.addressof(src), len(chunk), 0)
    ob = _Buf(ctypes.addressof(dst), occ, 0)
    try:
        while True:
            r = z.ZSTD_decompressStream(ds, ctypes.byref(ob),
                                        ctypes.byref(ib))
            if z.ZSTD_isError(r):
                return False, dst.raw[:ob.pos] + bytes(occ - ob.pos), \
                    z.ZSTD_getErrorName(r).decode()
            if not (r != 0 and ib.pos < ib.size and ob.pos < ob.size):
                break
        return ob.pos == occ, dst.raw[:ob.pos] + bytes(occ - ob.pos), \
            None if ob.pos == occ else f"short {occ - ob.pos} bytes"
    finally:
        z.ZSTD_freeDStream(ds)


_ZSTD_PARAMS = {"level": 100, "window_log": 101, "ldm": 160,
                "content_size": 200, "checksum": 201}


def zstd_frame(data: bytes, streaming: bool = False, **params) -> bytes:
    """A zstd frame of data (ZSTD_compress2, or as libtiff's ZSTDEncode
    streams a chunk: ZSTD_e_continue then ZSTD_e_end, no content size).
    params: level, window_log, ldm, content_size, checksum."""
    z = libzstd()
    cc = z.ZSTD_createCCtx()
    try:
        for k, v in params.items():
            r = z.ZSTD_CCtx_setParameter(cc, _ZSTD_PARAMS[k], int(v))
            if z.ZSTD_isError(r):
                raise ValueError(f"zstd refused {k}={v}")
        cap = z.ZSTD_compressBound(len(data)) + 64
        out = ctypes.create_string_buffer(cap)
        if not streaming:
            n = z.ZSTD_compress2(cc, out, cap, data, len(data))
            if z.ZSTD_isError(n):
                raise ValueError("zstd refused the data")
            return out.raw[:n]
        src = ctypes.create_string_buffer(data, max(1, len(data)))
        ib = _Buf(ctypes.addressof(src), len(data), 0)
        ob = _Buf(ctypes.addressof(out), cap, 0)
        z.ZSTD_compressStream2(cc, ctypes.byref(ob), ctypes.byref(ib), 0)
        while z.ZSTD_compressStream2(cc, ctypes.byref(ob), ctypes.byref(ib),
                                     2):
            pass
        return out.raw[:ob.pos]
    finally:
        z.ZSTD_freeCCtx(cc)


class _Stream(ctypes.Structure):
    _fields_ = [("next_in", ctypes.c_void_p), ("avail_in", ctypes.c_size_t),
                ("total_in", ctypes.c_uint64),
                ("next_out", ctypes.c_void_p), ("avail_out", ctypes.c_size_t),
                ("total_out", ctypes.c_uint64),
                ("allocator", ctypes.c_void_p), ("internal", ctypes.c_void_p),
                ("reserved", ctypes.c_void_p * 4),
                ("seek_pos", ctypes.c_uint64), ("ri2", ctypes.c_uint64),
                ("ri3", ctypes.c_size_t), ("ri4", ctypes.c_size_t),
                ("re1", ctypes.c_int), ("re2", ctypes.c_int)]


class _Filter(ctypes.Structure):
    _fields_ = [("id", ctypes.c_uint64), ("options", ctypes.c_void_p)]


@functools.cache
def liblzma():
    """Pillow's liblzma 5.8.2."""
    lz = ctypes.CDLL(_pillow_lib("liblzma"))
    sp = ctypes.POINTER(_Stream)
    lz.lzma_stream_decoder.argtypes = [sp, ctypes.c_uint64, ctypes.c_uint32]
    lz.lzma_alone_encoder.argtypes = [sp, ctypes.c_void_p]
    lz.lzma_code.argtypes = [sp, ctypes.c_int]
    lz.lzma_end.argtypes = [sp]
    lz.lzma_lzma_preset.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lz.lzma_lzma_preset.restype = ctypes.c_bool
    lz.lzma_stream_buffer_encode.argtypes = [
        ctypes.POINTER(_Filter), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_size_t]
    return lz


def lzma_libtiff(chunk: bytes, occ: int, fill: int = 0):
    """libtiff's LZMADecode of a chunk into occ bytes (filled with fill):
    lzma_stream_decoder(UINT64_MAX, 0), lzma_code until the stream ends,
    an error or the output full; kept where the output is full, else
    zeroed past the output position. (kept, the buffer, the last
    lzma_ret)."""
    lz = liblzma()
    s = _Stream()
    if lz.lzma_stream_decoder(ctypes.byref(s), 2 ** 64 - 1, 0):
        raise RuntimeError("lzma_stream_decoder")
    src = ctypes.create_string_buffer(bytes(chunk), max(1, len(chunk)))
    dst = ctypes.create_string_buffer(bytes([fill]) * occ, max(1, occ))
    s.next_in, s.avail_in = ctypes.addressof(src), len(chunk)
    s.next_out, s.avail_out = ctypes.addressof(dst), occ
    try:
        while True:
            ret = lz.lzma_code(ctypes.byref(s), 0)
            if ret != 0 or s.avail_out == 0:
                break
        pos = occ - s.avail_out
        return s.avail_out == 0, dst.raw[:pos] + bytes(occ - pos), ret
    finally:
        lz.lzma_end(ctypes.byref(s))


FILTERS = {"delta": 3, "x86": 4, "powerpc": 5, "ia64": 6, "arm": 7,
           "armthumb": 8, "sparc": 9, "arm64": 10, "riscv": 11}
CHECKS = {"none": 0, "crc32": 1, "crc64": 4, "sha256": 10}


def xz_stream(data: bytes, preset: int = 6, extreme: bool = False,
              check: str = "crc64", filters=(), dict_size: int = None,
              lclppb=None) -> bytes:
    """An .xz stream of data (lzma_stream_buffer_encode): filters is a
    chain of (name, argument) ahead of LZMA2 (delta: its distance; BCJ:
    its start offset)."""
    lz = liblzma()
    opts = ctypes.create_string_buffer(256)
    if lz.lzma_lzma_preset(opts, preset | (0x80000000 if extreme else 0)):
        raise ValueError(f"no preset {preset}")
    if dict_size is not None:
        struct.pack_into("<I", opts, 0, dict_size)
    if lclppb is not None:
        struct.pack_into("<III", opts, 20, *lclppb)
    chain = (_Filter * 6)()
    keep = [opts]
    for i, (name, arg) in enumerate(filters):
        o = ctypes.create_string_buffer(64)
        struct.pack_into("<iI" if name == "delta" else "<I", o, 0,
                         *((0, arg) if name == "delta" else (arg,)))
        keep.append(o)
        chain[i] = _Filter(FILTERS[name], ctypes.addressof(o))
    chain[len(filters)] = _Filter(0x21, ctypes.addressof(opts))
    chain[len(filters) + 1] = _Filter(2 ** 64 - 1, None)
    cap = 2 * len(data) + 65536
    out = ctypes.create_string_buffer(cap)
    pos = ctypes.c_size_t(0)
    if lz.lzma_stream_buffer_encode(chain, CHECKS[check], None, data,
                                    len(data), out, ctypes.byref(pos), cap):
        raise ValueError(f"liblzma refused {filters}")
    return out.raw[:pos.value]


def lzma_alone(data: bytes) -> bytes:
    """An .lzma (LZMA_Alone) file of data at preset 6."""
    lz = liblzma()
    opts = ctypes.create_string_buffer(256)
    lz.lzma_lzma_preset(opts, 6)
    s = _Stream()
    if lz.lzma_alone_encoder(ctypes.byref(s), opts):
        raise RuntimeError("lzma_alone_encoder")
    src = ctypes.create_string_buffer(data, max(1, len(data)))
    cap = 2 * len(data) + 65536
    out = ctypes.create_string_buffer(cap)
    s.next_in, s.avail_in = ctypes.addressof(src), len(data)
    s.next_out, s.avail_out = ctypes.addressof(out), cap
    try:
        while lz.lzma_code(ctypes.byref(s), 3) == 0:      # LZMA_FINISH
            pass
        return out.raw[:cap - s.avail_out]
    finally:
        lz.lzma_end(ctypes.byref(s))


# -- frames and streams changed by hand ---------------------------------------

def skippable(payload: bytes, nibble: int = 0) -> bytes:
    return struct.pack("<LL", 0x184D2A50 + nibble, len(payload)) + payload


def with_window(frame: bytes, byte: int) -> bytes:
    """A frame without a single segment (no content size) with its window
    descriptor set to byte."""
    assert frame[4] & 0x20 == 0
    return frame[:5] + bytes([byte]) + frame[6:]


def with_dict_id(frame: bytes, dict_id: int) -> bytes:
    """The frame with a 4-byte dictionary ID in its header."""
    fhd = frame[4]
    assert fhd & 3 == 0
    at = 5 + (0 if fhd & 0x20 else 1)
    return frame[:4] + bytes([fhd | 3]) + frame[5:at] + \
        struct.pack("<L", dict_id) + frame[at:]


def blocks_of(frame: bytes):
    """(offset, type, size, last) of each block of a frame."""
    fhd = frame[4]
    single = fhd >> 5 & 1
    at = 5 + (not single) + (0, 1, 2, 4)[fhd & 3] + \
        (0, 2, 4, 8)[fhd >> 6] + (single and not fhd >> 6)
    out = []
    while True:
        h = frame[at] | frame[at + 1] << 8 | frame[at + 2] << 16
        typ, size, last = h >> 1 & 3, h >> 3, h & 1
        out.append((at, typ, size, last))
        at += 3 + (1 if typ == 1 else size)
        if last:
            return out


def with_content_size(frame: bytes, size: int) -> bytes:
    """A frame whose content size field (2, 4 or 8 bytes) says size."""
    fhd = frame[4]
    assert fhd >> 6 and fhd & 3 == 0
    at = 5 + (0 if fhd & 0x20 else 1)
    field = {1: ("<H", size - 256), 2: ("<L", size), 3: ("<Q", size)}
    fmt, value = field[fhd >> 6]
    n = struct.calcsize(fmt)
    return frame[:at] + struct.pack(fmt, value) + frame[at + n:]


def _vli(value: int) -> bytes:
    out = bytearray()
    while value >= 0x80:
        out.append(value & 0x7F | 0x80)
        value >>= 7
    return bytes(out + bytes([value]))


def _read_vli(data: bytes, at: int):
    value, shift = 0, 0
    while True:
        b = data[at]
        value |= (b & 0x7F) << shift
        at += 1
        shift += 7
        if b < 0x80:
            return value, at


def xz_unpadded(stream: bytes) -> int:
    """A one-block .xz's block header, data and check, as its index says
    (the block's unpadded size)."""
    at = xz_index_at(stream)
    count, p = _read_vli(stream, at + 1)
    assert count == 1
    return _read_vli(stream, p)[0]


def xz_blocks(*streams: bytes) -> bytes:
    """One .xz stream holding the blocks of one-block streams (same
    check), its index made anew."""
    import zlib

    blocks, records = [], []
    for st_ in streams:
        at = xz_index_at(st_)
        blocks.append(st_[12:at])
        count, p = _read_vli(st_, at + 1)
        assert count == 1
        unpadded, p = _read_vli(st_, p)
        size, p = _read_vli(st_, p)
        records.append(_vli(unpadded) + _vli(size))
    index = b"\0" + _vli(len(streams)) + b"".join(records)
    index += bytes(-len(index) % 4)
    index += struct.pack("<L", zlib.crc32(index))
    head = streams[0][:12]
    body = struct.pack("<L", len(index) // 4 - 1) + head[6:8]
    foot = struct.pack("<L", zlib.crc32(body)) + body + b"YZ"
    return head + b"".join(blocks) + index + foot


def with_block_u32(stream: bytes, old: int, new: int) -> bytes:
    """The stream with a 32-bit value in its block header (a BCJ filter's
    start offset) replaced, the header's CRC32 made anew."""
    import zlib

    size = (stream[12] + 1) * 4
    head = bytearray(stream[12:12 + size])
    at = head.index(struct.pack("<L", old))
    head[at:at + 4] = struct.pack("<L", new)
    head[-4:] = struct.pack("<L", zlib.crc32(bytes(head[:-4])))
    return stream[:12] + bytes(head) + stream[12 + size:]


def xz_lzma1(data: bytes) -> bytes:
    """An .xz stream whose one block's filter is LZMA1 (an .lzma file's
    data and properties, with its end marker), written by hand: liblzma's
    encoder refuses the chain."""
    import zlib

    alone = lzma_alone(data)
    body = b"\0" + _vli(0x4000000000000001) + _vli(5) + alone[:5]
    size = 1 + len(body) + 4
    head = bytes([(size + 3) // 4 - 1]) + body + bytes(-size % 4)
    head += struct.pack("<L", zlib.crc32(head))
    raw = alone[13:]
    block = head + raw + bytes(-len(raw) % 4) + \
        struct.pack("<L", zlib.crc32(data))
    flags = b"\0\1"
    index = b"\0" + _vli(1) + _vli(len(head) + len(raw) + 4) + \
        _vli(len(data))
    index += bytes(-len(index) % 4)
    index += struct.pack("<L", zlib.crc32(index))
    back = struct.pack("<L", len(index) // 4 - 1) + flags
    return b"\xfd7zXZ\0" + flags + struct.pack("<L", zlib.crc32(flags)) + \
        block + index + struct.pack("<L", zlib.crc32(back)) + back + b"YZ"


def xz_check_id(stream: bytes, check: int) -> bytes:
    """An .xz stream with its header's and footer's check ID replaced
    (CRC32s made anew); the block's check field keeps its size."""
    import zlib

    flags = bytes([0, check])
    head = stream[:6] + flags + struct.pack("<L", zlib.crc32(flags))
    foot = stream[-12:]
    body = foot[4:8] + flags
    foot = struct.pack("<L", zlib.crc32(body)) + body + foot[10:]
    return head + stream[12:-12] + foot


def _flip(data: bytes, at: int, bit: int = 0) -> bytes:
    return data[:at] + bytes([data[at] ^ (1 << bit)]) + data[at + 1:]


def bad_checksum(frame: bytes) -> bytes:
    """The frame with its content checksum's last byte changed."""
    return _flip(frame, len(frame) - 1)


def xz_index_at(stream: bytes) -> int:
    """Where a one-stream .xz's index begins (the footer's backward
    size)."""
    size = (struct.unpack_from("<L", stream, len(stream) - 8)[0] + 1) * 4
    return len(stream) - 12 - size


def flipped_kept(frame: bytes, strip: bytes, decode, start: int = 0):
    """The first byte flip past the middle of frame (and past start) that
    decode keeps with 1 to 3 bytes of the strip changed (deterministic:
    the libraries decide)."""
    for at in range(max(len(frame) // 2, start), len(frame)):
        for bit in range(8):
            f = _flip(frame, at, bit)
            kept, got, _ = decode(f, len(strip))
            if kept and 0 < sum(a != b for a, b in zip(got, strip)) <= 3:
                return f
    raise RuntimeError("no flip kept")


def literal_streams(frame: bytes) -> range:
    """Where the first block's Huffman-coded literals lie past their tree
    description's likely end (the second half of the section)."""
    at, typ, _, _ = blocks_of(frame)[0]
    assert typ == 2
    h = frame[at + 3:at + 8]
    assert h[0] & 3 == 2 and (h[0] >> 2) & 3
    lh = (h[0] >> 2) & 3
    lhc = int.from_bytes(h[:4], "little")
    size, csize = ((4, lhc >> 18) if lh == 2 else
                   (5, (lhc >> 22) + (h[4] << 10)) if lh == 3 else
                   (3, (lhc >> 14) & 0x3FF))
    start = at + 3 + size
    return range(start + csize // 2, start + csize)


def flipped_in_streams(frame: bytes, strip: bytes):
    """The first bit flip inside the first block's four literal streams
    that libzstd keeps though the stream's codes no longer line up (more
    than 8 bytes changed): its x86-64 loop decodes each stream to its
    segment's end and checks no stream's end."""
    for at in literal_streams(frame):
        for bit in range(8):
            f = _flip(frame, at, bit)
            kept, got, _ = zstd_libtiff(f, len(strip))
            if kept and sum(a != b for a, b in zip(got, strip)) > 8:
                return f
    raise RuntimeError("no flip in the streams kept")


def flipped_late_fault(stream: bytes, strip: bytes):
    """The first byte flip in an .xz stream's data that liblzma keeps
    (its fault comes after the output is full) with 1 to 3 bytes
    changed."""
    for at in range(len(stream) - 30, 12, -1):
        for bit in range(8):
            f = _flip(stream, at, bit)
            kept, got, ret = lzma_libtiff(f, len(strip))
            if kept and ret != 0 and ret != 1 and \
                    0 < sum(a != b for a, b in zip(got, strip)) <= 3:
                return f
    raise RuntimeError("no late fault kept")


# -- the cases ----------------------------------------------------------------

def picture(seed: int, h: int, w: int) -> np.ndarray:
    """Bands and steps with sparse noise: (h, w, 3) uint8 that both codecs
    compress at these small sizes (noise() is what they store as it
    is)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx // 5) * 40 + (yy // 4) * 20, (xx // 3) * 30 + 60,
                     (yy // 2) * 25 + (xx // 7) * 60], -1) % 256
    spots = rng.random((h, w, 1)) < 0.15
    return (base + spots * rng.integers(-2, 3, (h, w, 3))).clip(
        0, 255).astype(np.uint8)


def noise(seed: int, h: int, w: int, channels: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (h, w, channels), np.uint8)


def skewed(seed: int, h: int, w: int) -> np.ndarray:
    """Random bytes drawn mostly small (a geometric spread): few matches,
    literals that Huffman coding halves."""
    rng = np.random.default_rng(seed)
    return np.minimum(rng.geometric(0.1, (h, w, 3)) - 1, 255).astype(
        np.uint8)


def code_like(kind: str, seed: int, n: int) -> bytes:
    """n bytes of noise strewn with what the BCJ filter kind converts
    (calls, branches, jumps, address pairs), so that its decoder changes
    bytes."""
    rng = np.random.default_rng(seed)
    b = bytearray(rng.integers(0, 256, n, np.uint8).tobytes())
    r = lambda: int(rng.integers(0, 256))                # noqa: E731
    for at in range(0, n - 16, 12):
        if kind == "x86":
            b[at:at + 5] = bytes([0xE8, r(), r(), r(), (0, 0xFF)[at % 2]])
        elif kind == "powerpc":
            a = at & ~3
            b[a:a + 4] = bytes([0x48 | r() & 3, r(), r(), r() & 0xFC | 1])
        elif kind == "ia64":
            a = at & ~15
            b[a] = 0x10 | b[a] & 0xE0
            slot = (5 << 37) | (int(rng.integers(0, 2 ** 20)) << 13)
            bundle = int.from_bytes(b[a:a + 16], "little")
            bundle &= ~(((1 << 41) - 1) << 87)
            bundle |= slot << 87
            b[a:a + 16] = bundle.to_bytes(16, "little")
        elif kind == "arm":
            a = at & ~3
            b[a + 3] = 0xEB
        elif kind == "armthumb":
            a = at & ~1
            b[a + 1] = 0xF0 | r() & 7
            b[a + 3] = 0xF8 | r() & 7
        elif kind == "sparc":
            a = at & ~3
            b[a:a + 2] = (bytes([0x40, r() & 0x3F]) if at % 24 else
                          bytes([0x7F, 0xC0 | r() & 0x3F]))
        elif kind == "arm64":
            a = at & ~3
            word = (0x94000000 | int(rng.integers(0, 2 ** 26))) if at % 24 \
                else (0x90000000 | (r() & 3) << 29 |
                      int(rng.integers(0, 2 ** 14)) << 5 | r() & 31)
            b[a:a + 4] = struct.pack("<L", word)
        elif kind == "riscv":
            a = at & ~1
            if at % 36 == 0:
                b[a:a + 4] = bytes([0xEF, r() & 0xF2, r(), r()])
            elif at % 36 == 12:
                auipc = 0x00000097 | int(rng.integers(0, 2 ** 20)) << 12
                jalr = 0x000080E7 | int(rng.integers(0, 2 ** 12)) << 20
                b[a:a + 8] = struct.pack("<LL", auipc, jalr)
            else:
                b[a] = 0x17 | b[a] & 0x80
    return bytes(b)


def strip_file(rgb: np.ndarray, chunk: bytes, compression: int,
               photometric: int = 2, more=None) -> bytes:
    """A one-strip TIFF of rgb's size around a chunk of bytes."""
    h, w, spp = rgb.shape
    tags = {256: w, 257: h, 258: (8,) * spp if spp > 1 else 8,
            259: compression, 262: photometric, 277: spp, 273: tc.CHUNKS,
            278: h, 279: tc.CHUNKS}
    tags.update(more or {})
    return tc.tiff_file(tags, [chunk])


def ycbcr_strips(rgb: np.ndarray, chunks_of, compression: int) -> bytes:
    """A YCbCr 2x2 TIFF (TIFFRGBAImage's route) of two strips:
    chunks_of(k, packed strip bytes) gives strip k's chunk."""
    h, w = rgb.shape[:2]
    ycc = tj.ycbcr(rgb)
    rps = h // 2 + (h // 2) % 2
    chunks = [chunks_of(k, tj.blocks(ycc[y:y + rps], 2, 2).tobytes())
              for k, y in enumerate(range(0, h, rps))]
    return tc.tiff_file({256: w, 257: h, 258: (8, 8, 8), 259: compression,
                         262: 6, 277: 3, 530: (2, 2), 273: tc.CHUNKS,
                         278: rps, 279: tc.CHUNKS}, chunks)


def _libtiff_cases(out: dict):
    rgb = picture(5, 29, 37)
    lt = tc.libtiff
    for codec, comp in (("zstd", 50000), ("lzma", 34925)):
        p = f"lw_{codec}"
        out[f"{p}_rgb_strips8_37x29.tif"] = lt(rgb, photometric=2,
                                              compression=comp)
        out[f"{p}_rgb_tiles16_37x29.tif"] = lt(
            rgb, photometric=2, compression=comp, tile_width=16,
            tile_height=16)
        out[f"{p}_rgb_planar_37x29.tif"] = lt(rgb, photometric=2, planar=2,
                                             compression=comp)
        out[f"{p}_rgb_planar_tiles16_37x29.tif"] = lt(
            rgb, photometric=2, planar=2, compression=comp, tile_width=16,
            tile_height=16)
        out[f"{p}_rgb_pred2_37x29.tif"] = lt(rgb, photometric=2,
                                            compression=comp, predictor=2)
        out[f"{p}_rgb_pred2_tiles16_37x29.tif"] = lt(
            rgb, photometric=2, compression=comp, predictor=2,
            tile_width=16, tile_height=16)
        g16 = (rgb[..., :1].astype(np.uint16) * 257)
        out[f"{p}_grey16_pred2_37x29.tif"] = lt(g16, bps=16,
                                               compression=comp, predictor=2)
        out[f"{p}_grey16_pred2_be_37x29.tif"] = lt(
            g16, bps=16, compression=comp, predictor=2, bigendian=1)
        g32 = (rgb[..., :1].astype(np.uint32) * 65537)
        out[f"{p}_grey32_pred2_37x29.tif"] = lt(g32, bps=32,
                                               compression=comp, predictor=2)
        f32 = rgb[..., :1].astype(np.float32) / 7
        out[f"{p}_float32_pred3_37x29.tif"] = lt(f32, bps=32,
                                                compression=comp, predictor=3)
        out[f"{p}_float32_pred3_be_37x29.tif"] = lt(
            f32, bps=32, compression=comp, predictor=3, bigendian=1)
        out[f"{p}_rgb_bigtiff_37x29.tif"] = lt(
            rgb, photometric=2, compression=comp, bigtiff=1)
        out[f"{p}_rgb_tiles16_be_37x29.tif"] = lt(
            rgb, photometric=2, compression=comp, tile_width=16,
            tile_height=16, bigendian=1)
        out[f"{p}_rgb_fillorder2_37x29.tif"] = lt(rgb, photometric=2,
                                                 compression=comp,
                                                 fillorder=2)
        rgba = np.concatenate([rgb, rgb[..., :1]], -1)
        out[f"{p}_rgba_37x29.tif"] = lt(rgba, photometric=2, extra=(2,),
                                       compression=comp)
        out[f"{p}_cmyk_planar_37x29.tif"] = lt(rgba, photometric=5,
                                              planar=2, compression=comp)
        out[f"{p}_grey4_37x29.tif"] = lt(rgb[..., :1] % 16, bps=4,
                                        compression=comp)
        out[f"{p}_palette8_37x29.tif"] = lt(
            rgb[..., :1], photometric=3, compression=comp,
            colormap=np.arange(768, dtype=np.uint16).reshape(3, 256) * 85)
        big = noise(6, 40, 64)
        out[f"{p}_noise_rgb_64x40.tif"] = lt(big, photometric=2,
                                            compression=comp,
                                            rows_per_strip=40)
    for o in range(1, 9):
        out[f"lw_zstd_rgb_orient{o}_37x29.tif"] = lt(
            rgb, photometric=2, compression=50000, orientation=o)
    for level in (1, 3, 9, 19, 22):
        out[f"lw_zstd_level{level}_37x29.tif"] = lt(
            rgb, photometric=2, compression=50000, zstd_level=level)
    for preset in (1, 6, 9):
        out[f"lw_lzma_preset{preset}_37x29.tif"] = lt(
            rgb, photometric=2, compression=34925, lzma_preset=preset)


def _pillow_cases(out: dict):
    rgb = picture(7, 13, 19)
    for codec in ("zstd", "lzma"):
        for mode in ("RGB", "L", "LA", "RGBA", "CMYK", "1", "P", "I;16",
                     "I", "F", "YCbCr"):
            name = mode.lower().replace(";", "")
            out[f"pw_{codec}_{name}_19x13.tif"] = tj.pillow_tiff(
                rgb, mode, compression=codec)
        for o in (3, 6):
            out[f"pw_{codec}_rgb_orient{o}_19x13.tif"] = tj.pillow_tiff(
                rgb, "RGB", compression=codec, tiffinfo={274: o})


def _zstd_cases(out: dict):
    rgb = picture(8, 13, 19)
    s = rgb.tobytes()
    z = 50000

    def put(name, chunk, image=rgb):
        out[f"z_{name}_19x13.tif"] = strip_file(image, chunk, z)

    put("two_frames_first_short", zstd_frame(s[:300]) + zstd_frame(s[300:]))
    put("skippable_first", skippable(b"tiff") + zstd_frame(s))
    put("skippable_nibble15_first", skippable(b"", 15) + zstd_frame(s))
    put("bytes_after_full_frame", zstd_frame(s) + b"\x28\xb5\x2f\xfd junk")
    put("frame_longer_than_strip", zstd_frame(s + s[:200], checksum=1))
    put("longer_bad_checksum",
        bad_checksum(zstd_frame(s + s[:200], checksum=1)))
    put("bad_checksum", bad_checksum(zstd_frame(s, checksum=1)))
    put("bad_checksum_no_content_size",
        bad_checksum(zstd_frame(s, checksum=1, content_size=0)))
    put("no_content_size", zstd_frame(s, content_size=0))
    put("checksum", zstd_frame(s, checksum=1))
    put("frame_shorter_than_strip", zstd_frame(s[:-10]))
    wild = noise(9, 13, 19)
    raw = zstd_frame(wild.tobytes(), content_size=0)
    assert blocks_of(raw)[-1][1] == 0                     # a raw block
    put("cut_last4", raw[:-4], wild)
    put("cut_mid_raw_block", raw[:len(raw) // 2], wild)
    put("cut_header", zstd_frame(s)[:5])
    # bytes with few matches and a skewed spread: literals Huffman-coded in
    # four streams, which the library's x86-64 loop reads without checking
    # their ends
    noisy = skewed(8, 29, 37)
    l19 = zstd_frame(noisy.tobytes(), level=19)
    at = 0
    for k in "abc":
        f = flipped_kept(l19, noisy.tobytes(), zstd_libtiff, at)
        at = next(i for i in range(len(f)) if f[i] != l19[i]) + 1
        out[f"z_flipped_kept_l19_{k}_37x29.tif"] = strip_file(noisy, f, z)
    out["z_flipped_literal_stream_37x29.tif"] = strip_file(
        noisy, flipped_in_streams(l19, noisy.tobytes()), z)
    for level in (-5, -1, 1, 3, 6, 9, 15, 19, 22):
        put(f"level{level}", zstd_frame(s, level=level))
        put(f"level{level}_streamed",
            zstd_frame(s, level=level, streaming=True))
    put("ldm", zstd_frame(s * 1, ldm=1, level=19, window_log=20))
    base = zstd_frame(s, content_size=0)
    put("window_log10", with_window(base, 0))
    put("window_log27", with_window(base, 17 << 3))
    put("window_log27_and_more", with_window(base, 17 << 3 | 1))
    put("window_log28", with_window(base, 18 << 3))
    put("window_log31", with_window(base, 21 << 3))
    put("window_log28_content_size", _window_fcs(s))
    put("content_size_past_strip",
        with_content_size(zstd_frame(s, level=19), len(s) + 10))
    put("content_size_short_of_frame",
        with_content_size(zstd_frame(s, level=19), len(s) - 10))
    put("dict_id", with_dict_id(zstd_frame(s), 7))
    put("dict_id_no_content_size", with_dict_id(base, 1))
    put("legacy_v07_magic", b"\x27\xb5\x2f\xfd" + bytes(40))
    put("legacy_v05_magic", b"\x25\xb5\x2f\xfd" + zstd_frame(s)[4:])
    put("unknown_magic", b"\x28\xb5\x2f\xfe" + zstd_frame(s)[4:])
    reserved = bytearray(zstd_frame(s))
    at = blocks_of(bytes(reserved))[0][0]
    reserved[at] |= 6
    put("reserved_block_type", bytes(reserved))
    flat = np.full((13, 19, 3), 77, np.uint8)
    put("rle_block", zstd_frame(flat.tobytes(), content_size=0), flat)
    put("rle_block_short_strip", zstd_frame(flat.tobytes()[:-3]), flat)
    # a few blocks: 64 KiB of content over a window of 2^16 (three planes of
    # a strip of 128 x 171 RGB)
    wide = picture(10, 171, 128)
    out["z_blocks_128x171.tif"] = strip_file(
        wide, zstd_frame(wide.tobytes(), level=12, checksum=1), z)
    out["z_blocks_window16_128x171.tif"] = strip_file(
        wide, zstd_frame(wide.tobytes(), level=3, window_log=16,
                         content_size=0), z)
    # YCbCr: TIFFRGBAImage keeps the bytes of a refused second strip
    ys = picture(11, 26, 38)

    def second(fault):
        return lambda k, b: zstd_frame(b) if k == 0 else fault(b)
    out["z_ycbcr22_38x26.tif"] = ycbcr_strips(
        ys, lambda k, b: zstd_frame(b, checksum=k), z)
    out["z_ycbcr22_cut_last4_38x26.tif"] = ycbcr_strips(
        ys, second(lambda b: zstd_frame(b, level=-5,
                                        content_size=0)[:-4]), z)
    out["z_ycbcr22_bad_checksum_38x26.tif"] = ycbcr_strips(
        ys, second(lambda b: bad_checksum(zstd_frame(b, checksum=1))), z)
    out["z_ycbcr22_two_frames_38x26.tif"] = ycbcr_strips(
        ys, second(lambda b: zstd_frame(b[:100]) + zstd_frame(b[100:])), z)
    out["z_ycbcr22_skippable_38x26.tif"] = ycbcr_strips(
        ys, second(lambda b: skippable(b"x") + zstd_frame(b)), z)


def _window_fcs(s: bytes) -> bytes:
    """A frame with a content size and a window of 2^28 (not a single
    segment): decoded in one pass, where no window limit applies."""
    f = zstd_frame(s, content_size=0)
    fhd = f[4]
    return f[:4] + bytes([fhd | 0x80]) + bytes([18 << 3]) + \
        struct.pack("<L", len(s)) + f[6:]


def _lzma_cases(out: dict):
    rgb = picture(12, 13, 19)
    s = rgb.tobytes()
    x = 34925

    def put(name, chunk, image=rgb):
        out[f"x_{name}_19x13.tif"] = strip_file(image, chunk, x)

    put("delta", xz_stream(s, filters=(("delta", 3),)))
    put("x86", xz_stream(s, filters=(("x86", 0),)))
    for k, name in enumerate(("x86", "powerpc", "ia64", "arm", "armthumb",
                              "sparc", "arm64", "riscv")):
        put(name if name != "x86" else "x86_picture",
            xz_stream(s, filters=((name, 0),)))
        code = np.frombuffer(code_like(name, 20 + k, len(s)),
                             np.uint8).reshape(rgb.shape)
        put(f"{name}_code", xz_stream(code.tobytes(),
                                      filters=((name, 0),)), code)
    put("x86_start_offset", xz_stream(s, filters=(("x86", 1001),)))
    put("arm_start_offset", xz_stream(s, filters=(("arm", 4096),)))
    # liblzma's encoder refuses an ARM start offset off its alignment of 4
    put("arm_start_offset_misaligned", with_block_u32(
        xz_stream(s, filters=(("arm", 4096),)), 4096, 4098))
    put("delta_x86", xz_stream(s, filters=(("delta", 6), ("x86", 0))))
    put("preset9e", xz_stream(s, preset=9, extreme=True))
    for preset in range(10):
        put(f"preset{preset}", xz_stream(s, preset=preset))
    for check in ("none", "crc32", "crc64", "sha256"):
        put(f"check_{check}", xz_stream(s, check=check))
    put("check_id2", xz_check_id(xz_stream(s, check="crc32"), 2))
    put("check_id15", xz_check_id(xz_stream(s, check="crc32"), 15))
    good = xz_stream(s, check="crc32")
    put("corrupt_index", _flip(good, xz_index_at(good) + 1))
    put("corrupt_index_crc", _flip(good, len(good) - 13))
    put("bad_crc32", _flip(good, xz_index_at(good) - 1))
    put("bad_header_crc", _flip(good, 9))
    put("bad_block_header_crc", _flip(good, 14))
    put("flipped_kept", flipped_late_fault(xz_stream(s, check="crc32"), s))
    put("two_streams_first_short",
        xz_stream(s[:300]) + xz_stream(s[300:]))
    put("two_streams", xz_stream(s) + xz_stream(s[:40]))
    first = xz_stream(s[:400], check="crc32")
    second = xz_stream(s[400:], check="crc32")
    put("two_blocks", xz_blocks(first, second))
    put("two_blocks_bad_first_crc32",
        xz_blocks(_flip(first, xz_index_at(first) - 1), second))
    # the last byte of the first block's LZMA2 chunk (before its end
    # marker): its range coder does not end at zero
    put("two_blocks_first_rc_unfinished",
        xz_blocks(_flip(first, 12 + xz_unpadded(first) - 4 - 2), second))
    put("lzma_alone", lzma_alone(s))
    put("lzma1_filter", xz_lzma1(s))
    put("cut_mid", good[:len(good) // 2])
    put("shorter_than_strip", xz_stream(s[:-5]))
    put("longer_than_strip", xz_stream(s + s[:99]))
    put("lc4_lp0_pb0", xz_stream(s, lclppb=(4, 0, 0)))
    put("lc0_lp2_pb4", xz_stream(s, lclppb=(0, 2, 4)))
    put("lc1_lp3_pb1", xz_stream(s, lclppb=(1, 3, 1)))
    wild = noise(13, 13, 19)
    put("uncompressed_chunks", xz_stream(wild.tobytes()), wild)
    put("uncompressed_chunks_x86", xz_stream(wild.tobytes(),
                                             filters=(("x86", 0),)), wild)
    wide = picture(14, 40, 64)
    out["x_small_dict_64x40.tif"] = strip_file(
        wide, xz_stream(wide.tobytes(), dict_size=4096), x)
    out["x_small_dict_arm64_64x40.tif"] = strip_file(
        wide, xz_stream(wide.tobytes(), dict_size=4096,
                        filters=(("arm64", 0),)), x)
    ys = picture(15, 26, 38)

    def second(fault):
        return lambda k, b: xz_stream(b) if k == 0 else fault(b)
    out["x_ycbcr22_38x26.tif"] = ycbcr_strips(
        ys, lambda k, b: xz_stream(b, filters=(("delta", 1),)), x)
    out["x_ycbcr22_cut_38x26.tif"] = ycbcr_strips(
        ys, second(lambda b: xz_stream(b)[:60]), x)
    out["x_ycbcr22_cut_x86_38x26.tif"] = ycbcr_strips(
        ys, second(lambda b: xz_stream(b, filters=(("x86", 0),))[:70]), x)
    out["x_ycbcr22_two_streams_38x26.tif"] = ycbcr_strips(
        ys, second(lambda b: xz_stream(b[:100]) + xz_stream(b[100:])), x)


def _webp_cases(out: dict):
    """WebP in TIFF: Pillow opens it and refuses it at load."""
    rgb = picture(16, 13, 19)
    out["webp_rgb_19x13.tif"] = strip_file(rgb, rgb.tobytes(), 50001)
    out["webp_ycbcr22_38x26.tif"] = ycbcr_strips(
        picture(17, 26, 38), lambda k, b: b, 50001)


def scene_cases(rgb: np.ndarray) -> dict:
    """The 640x480 scene for phase 9n."""
    lt = tc.libtiff
    rgb = np.ascontiguousarray(rgb, np.uint8)
    ycc = tj.ycbcr(rgb)
    return {
        SCENES[0]: lt(rgb, photometric=2, compression=50000,
                      rows_per_strip=16),
        SCENES[1]: lt(rgb, photometric=2, compression=50000, predictor=2,
                      rows_per_strip=16),
        SCENES[2]: lt(rgb, photometric=2, compression=34925, predictor=2,
                      lzma_preset=6, rows_per_strip=16),
        SCENES[3]: tj.ycbcr_file(
            ycc, (2, 2), (50000, lambda b: zstd_frame(
                b, level=9, streaming=True)), rows_per_strip=16),
        ROTATED: lt(rgb, photometric=2, compression=50000,
                    rows_per_strip=16, orientation=6),
    }


def cases() -> dict:
    from tests import torch_jpeg_fixtures

    out = {}
    _libtiff_cases(out)
    _pillow_cases(out)
    _zstd_cases(out)
    _lzma_cases(out)
    _webp_cases(out)
    out.update(scene_cases(torch_jpeg_fixtures.scene(0)))
    return out


def load(folder: str = FOLDER, name: str = DIGESTS) -> dict:
    with open(os.path.join(folder, name)) as f:
        return json.load(f)


def write(folder: str = FOLDER) -> dict:
    """Write every case and digests.json into folder; returns the
    digests."""
    import warnings

    warnings.simplefilter("ignore")
    os.makedirs(folder, exist_ok=True)
    for old in os.listdir(folder):
        if old.endswith(".tif"):
            os.remove(os.path.join(folder, old))
    digests = {}
    for name, data in sorted(cases().items()):
        path = os.path.join(folder, name)
        with open(path, "wb") as f:
            f.write(data)
        digests[name] = tc.reference(path)
    tc._dump(os.path.join(folder, DIGESTS), digests)
    return digests


def digest(img) -> str:
    return tj.digest(img)


if __name__ == "__main__":
    print(json.dumps(write(*sys.argv[1:]), indent=1, sort_keys=True))
