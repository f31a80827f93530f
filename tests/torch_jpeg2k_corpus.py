"""The JPEG 2000 corpus (tests/fixtures/torch_jpeg2k_corpus/): files the
JAX package hands to Pillow 12.1.0, whose Jpeg2KImagePlugin reads them
over OpenJPEG 2.5.4, and which the port reads in data/jpeg2k.py and
csrc/j2k_decode.cc.

Small files made from numpy seeds:

- ``pw_*``: Pillow's own writer: modes L, I;16, LA, RGB and RGBA;
  reversible and irreversible; the MCT on and off; 1 to 7 resolutions;
  code-block and precinct sizes; the five progressions; quality layers;
  tiles with image and tile offsets; PLT; ``no_jp2``; ``cinema_mode``;
  1xN and Nx1 images;
- ``ow_*``: tests/torch_j2k_writer.c over Pillow's bundled OpenJPEG:
  every code-block style bit of Part 1 and combinations of them; SOP and
  EPH; POC; RGN; subsampled components and sYCC; signed components;
  precisions 1 to 16; tile-parts; odd image offsets; Part 2's MCT
  (``opj_set_MCT``, left to others by its markers);
- ``jb_*``: JP2 files assembled here around such codestreams: CMYK, P
  and PA (``pclr``, ``cmap``), palettes Pillow reads and those it does
  not, colour spaces OpenJPEG knows and those it does not, ``ihdr`` that
  disagrees with SIZ, boxes out of place or after the codestream;
- ``pp_*``: codestreams whose packet headers this module moves into PPM
  or PPT marker segments (written with SOP and EPH, so each packet's
  header is found between them);
- ``dm_*``: codestreams and JP2 files changed or cut: a missing EOC, a
  short tile-part, Psot of 0, packet lengths past the data, headers
  OpenJPEG's checks refuse;
- ``ht_*``: code-block style bit 0x40 (HTJ2K) set in COD or COC, left to
  others by their markers;
- the 640x480 scene (tests/torch_jpeg_fixtures.py:scene 0) for
  chip_smoke.py's phase 9r: lossless, irreversible with the ICT,
  irreversible in 256x256 tiles, and its luminance's top 4 bits at 12
  bits. All committed.

``digests.json`` holds, for each file, each JAX route's pixels' sha256
(tests/torch_tiff_corpus.py:reference; null where the route fails) and
the size Pillow reads. Remake the corpus (Pillow, the JAX package, gcc
for the writer) with

  python -m tests.torch_jpeg2k_corpus [folder]

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

FOLDER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                      "torch_jpeg2k_corpus")
DIGESTS = "digests.json"
WRITER_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "torch_j2k_writer.c")
WRITER_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "tests")

SCENES = ("scene_lossless_640x480.jp2", "scene_ict_640x480.jp2",
          "scene_tiles_640x480.jp2", "scene_grey12_640x480.j2k")
# for chip_smoke.py's 9r: no scene under an Orientation (detect --img reads
# the rate scene), and the files the port leaves to PIL by their markers
ROTATED = None
LEFT_TO_PIL = ("ht_", "mct_")
PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")


def _sibling(name: str):
    if __package__:
        import importlib
        return importlib.import_module(f"{__package__}.{name}")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import importlib
    return importlib.import_module(name)


def picture(seed: int, h: int, w: int, channels: int = 3,
            high: int = 256) -> np.ndarray:
    """Smooth gradients with noise: coefficients in every band."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    out = np.empty((h, w, channels), np.int64)
    for c in range(channels):
        fy, fx = rng.random(2) * 0.4 + 0.05
        base = (np.sin(x * fx + c) + np.cos(y * fy - c)) * 0.25 + 0.5
        noise = rng.random((h, w)) * 0.3
        out[..., c] = np.clip((base * 0.7 + noise) * high, 0, high - 1)
    return out


# -- OpenJPEG, through the tests' writer ---------------------------------------

def pillow_libopenjp2() -> str:
    """The OpenJPEG Pillow bundles (pillow.libs/libopenjp2-*.so.2.5.4)."""
    import PIL

    found = glob.glob(os.path.join(os.path.dirname(os.path.dirname(
        PIL.__file__)), "pillow.libs", "libopenjp2-*.so.2.5.4"))
    if not found:
        raise RuntimeError("Pillow bundles no OpenJPEG 2.5.4 here")
    return found[0]


@functools.cache
def _writer():
    """tests/torch_j2k_writer.c built against Pillow's OpenJPEG into
    build/tests (named by a digest of the source and the library)."""
    lib_path = pillow_libopenjp2()
    with open(WRITER_SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read() + lib_path.encode()).hexdigest()[:16]
    path = os.path.join(WRITER_DIR, f"j2k_writer_{tag}.so")
    if not os.path.isfile(path):
        os.makedirs(WRITER_DIR, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        subprocess.run(["gcc", "-O2", "-fPIC", "-shared", "-o", tmp,
                        WRITER_SOURCE, lib_path,
                        f"-Wl,-rpath,{os.path.dirname(lib_path)}"],
                       check=True, capture_output=True)
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.torch_j2k_write.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ip, ip, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ip, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.torch_j2k_write.restype = ctypes.c_int64
    return lib


# -- OpenJPEG's own decode, as Pillow's Jpeg2KDecode.c drives it ---------------

class _OpjComp(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in
                ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd",
                 "resno_decoded", "factor")] + [
        ("data", ctypes.c_void_p), ("alpha", ctypes.c_uint16)]


class _OpjImage(ctypes.Structure):
    _fields_ = [("x0", ctypes.c_uint32), ("y0", ctypes.c_uint32),
                ("x1", ctypes.c_uint32), ("y1", ctypes.c_uint32),
                ("numcomps", ctypes.c_uint32), ("color_space", ctypes.c_int),
                ("comps", ctypes.POINTER(_OpjComp)),
                ("icc", ctypes.c_void_p), ("icc_len", ctypes.c_uint32)]


_READ = ctypes.CFUNCTYPE(ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
                         ctypes.c_void_p)
_SKIP = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p)
_MSG = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_void_p)


@functools.cache
def _openjpeg():
    lib = ctypes.CDLL(pillow_libopenjp2())
    vp = ctypes.c_void_p
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    sigs = {
        "opj_stream_create": ([ctypes.c_size_t, ctypes.c_int], vp),
        "opj_stream_set_read_function": ([vp, _READ], None),
        "opj_stream_set_skip_function": ([vp, _SKIP], None),
        "opj_stream_set_user_data": ([vp, vp, vp], None),
        "opj_stream_set_user_data_length": ([vp, ctypes.c_uint64], None),
        "opj_create_decompress": ([ctypes.c_int], vp),
        "opj_set_error_handler": ([vp, _MSG, vp], ctypes.c_int),
        "opj_set_default_decoder_parameters": ([vp], None),
        "opj_setup_decoder": ([vp, vp], ctypes.c_int),
        "opj_read_header": ([vp, vp, ctypes.POINTER(ctypes.POINTER(
            _OpjImage))], ctypes.c_int),
        "opj_read_tile_header": ([vp, vp, u32p, u32p, i32p, i32p, i32p,
                                  i32p, u32p, i32p], ctypes.c_int),
        "opj_decode_tile_data": ([vp, ctypes.c_uint32, vp, ctypes.c_uint32,
                                  vp], ctypes.c_int),
        "opj_end_decompress": ([vp, vp], ctypes.c_int),
        "opj_image_destroy": ([ctypes.POINTER(_OpjImage)], None),
        "opj_destroy_codec": ([vp], None),
        "opj_stream_destroy": ([vp], None),
    }
    for name, (args, res) in sigs.items():
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = res
    return lib


def openjpeg_tiles(data: bytes):
    """Pillow's calls into its bundled OpenJPEG on the file (a stream of
    1 MiB reads over the bytes, the file's length given): (the stage that
    failed or None, the colour space, the tiles in the order decoded as
    (index, x0, y0, x1, y1, data_size, decoded, buffer)), each tile into
    a zeroed buffer of its data_size."""
    lib = _openjpeg()
    codec = 0 if data[:4] == b"\xff\x4f\xff\x51" else 2
    pos = [0]

    def read(buf, n, user):
        k = min(n, len(data) - pos[0])
        if k <= 0:
            return ctypes.c_size_t(-1).value
        ctypes.memmove(buf, data[pos[0]:pos[0] + k], k)
        pos[0] += k
        return k

    def skip(n, user):
        pos[0] += n
        return n if pos[0] else -1

    keep = [_READ(read), _SKIP(skip), _MSG(lambda m, c: None)]
    s = lib.opj_stream_create(1 << 20, 1)
    lib.opj_stream_set_read_function(s, keep[0])
    lib.opj_stream_set_skip_function(s, keep[1])
    lib.opj_stream_set_user_data(s, None, None)
    lib.opj_stream_set_user_data_length(s, len(data))
    c = lib.opj_create_decompress(codec)
    lib.opj_set_error_handler(c, keep[2], None)
    params = ctypes.create_string_buffer(1 << 16)
    lib.opj_set_default_decoder_parameters(params)
    lib.opj_setup_decoder(c, params)
    img = ctypes.POINTER(_OpjImage)()
    tiles, stage, space = [], None, None
    try:
        if not lib.opj_read_header(s, c, ctypes.byref(img)):
            return "read_header", None, tiles
        space = img.contents.color_space
        while True:
            idx, size, nc = (ctypes.c_uint32() for _ in range(3))
            x0, y0, x1, y1, go = (ctypes.c_int32() for _ in range(5))
            if not lib.opj_read_tile_header(c, s, idx, size, x0, y0, x1, y1,
                                            nc, go):
                return "read_tile_header", space, tiles
            if not go.value:
                break
            buf = ctypes.create_string_buffer(size.value)
            ok = lib.opj_decode_tile_data(c, idx.value, buf, size.value, s)
            tiles.append((idx.value, x0.value, y0.value, x1.value, y1.value,
                          size.value, bool(ok), buf.raw))
            if not ok:
                return "decode_tile_data", space, tiles
        if not lib.opj_end_decompress(c, s):
            stage = "end_decompress"
        return stage, space, tiles
    finally:
        if img:
            lib.opj_image_destroy(img)
        lib.opj_destroy_codec(c)
        lib.opj_stream_destroy(s)


def _ints(values) -> ctypes.Array:
    values = list(values) or [0]
    return (ctypes.c_int * len(values))(*values)


def codestream(planes, comps, *, codec: int = 0, color_space: int = 0,
               offset=(0, 0), resolutions: int = 3, cblk=(64, 64),
               style: int = 0, irreversible: bool = False, roi=(-1, 0),
               scod: int = 0, progression: str = "LRCP", tiles=None,
               tile_offset=(0, 0), tile_parts: str = "", mct: int = 0,
               precincts=(), rates=(0.0,), pocs=(), custom_mct=None) -> bytes:
    """OpenJPEG's encode of the planes (one (h_c, w_c) int array a
    component, each of its own subsampled size) of an image whose size is
    planes[0]'s times comps[0]'s subsampling. comps: (dx, dy, prec, sgnd)
    each. precincts: (width, height) exponents from the highest
    resolution. pocs: (tile, resno0, compno0, layno1, resno1, compno1,
    progression) each. custom_mct: Part 2's matrix (opj_set_MCT)."""
    lib = _writer()
    dx0, dy0 = comps[0][0], comps[0][1]
    x0, y0 = offset
    # the image's size from component 0's plane
    h0, w0 = planes[0].shape
    width = (-(-(x0) // dx0) + w0) * dx0 - x0
    height = (-(-(y0) // dy0) + h0) * dy0 - y0
    samples = np.concatenate([np.asarray(p, np.int32).ravel()
                              for p in planes])
    opts = [codec, color_space, x0, y0, resolutions, cblk[0], cblk[1],
            style, int(irreversible), roi[0], roi[1], scod,
            PROGRESSIONS.index(progression), int(tiles is not None),
            tiles[0] if tiles else 0, tiles[1] if tiles else 0,
            tile_offset[0], tile_offset[1], int(bool(tile_parts)),
            ord(tile_parts) if tile_parts else 0, mct, len(precincts)]
    opts += [p[0] for p in precincts] + [p[1] for p in precincts]
    opts += [0] * (40 - len(opts))
    opts += [0 if custom_mct is None else 1]
    cap = 4 * samples.size + (1 << 16)
    out = np.zeros(cap, np.uint8)
    flat_pocs = [v for row in pocs for v in row]
    n = lib.torch_j2k_write(
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), width,
        height, len(comps), _ints(v for c in comps for v in c), _ints(opts),
        (ctypes.c_float * len(rates))(*rates), len(rates), _ints(flat_pocs),
        len(pocs), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        raise RuntimeError("OpenJPEG's encode failed")
    return out[:n].tobytes()


# -- JP2 boxes ----------------------------------------------------------------

def box(tbox: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + tbox + body


JP2_SIGNATURE = box(b"jP  ", b"\x0d\x0a\x87\x0a")
FTYP = box(b"ftyp", b"jp2 " + bytes(4) + b"jp2 ")


def ihdr(w: int, h: int, nc: int, bpc: int) -> bytes:
    return box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))


def colr(enumcs: int) -> bytes:
    return box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))


def pclr(entries, bits) -> bytes:
    """entries: rows of values, bits: each column's Bi byte."""
    body = struct.pack(">HB", len(entries), len(bits)) + bytes(bits)
    for row in entries:
        for v, b in zip(row, bits):
            size = ((b & 0x7F) + 1 + 7) // 8
            body += int(v).to_bytes(size, "big")
    return box(b"pclr", body)


def cmap(columns) -> bytes:
    return box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, c)
                                 for c in columns))


def jp2(cs: bytes, header_boxes, *, before=(), after=(),
        ftyp: bytes = FTYP) -> bytes:
    """A JP2 file: the signature, ftyp, the boxes before jp2h, jp2h of
    header_boxes, the codestream box, the boxes after it."""
    return (JP2_SIGNATURE + ftyp + b"".join(before) +
            box(b"jp2h", b"".join(header_boxes)) + box(b"jp2c", cs) +
            b"".join(after))


def siz_of(cs: bytes) -> dict:
    """The SIZ fields of a codestream."""
    _, _, xsiz, ysiz, xo, yo, _, _, _, _, csiz = struct.unpack_from(
        ">HHIIIIIIIIH", cs, 4)
    comps = [tuple(cs[42 + 3 * i:45 + 3 * i]) for i in range(csiz)]
    return {"w": xsiz - xo, "h": ysiz - yo, "nc": csiz, "comps": comps}


def wrap(cs: bytes, enumcs: int = None, extra=()) -> bytes:
    """The codestream as OpenJPEG's JP2 writer would box it (ihdr from
    SIZ, colr), with extra header boxes after colr."""
    s = siz_of(cs)
    bpcs = {c[0] for c in s["comps"]}
    bpc = bpcs.pop() if len(bpcs) == 1 else 255
    if enumcs is None:
        enumcs = 17 if s["nc"] <= 2 else 16
    return jp2(cs, [ihdr(s["w"], s["h"], s["nc"], bpc), colr(enumcs),
                    *extra])


# -- codestream surgery ---------------------------------------------------------

def segments(cs: bytes) -> list:
    """The main header's marker segments and the tile-parts: [(marker,
    bytes)] with ("tp", header segments, data) for each tile-part and
    ("eoc",) at the end."""
    out = []
    pos = 2
    while True:
        marker = struct.unpack_from(">H", cs, pos)[0]
        if marker == 0xFF90:
            break
        length = struct.unpack_from(">H", cs, pos + 2)[0]
        out.append((marker, cs[pos:pos + 2 + length]))
        pos += 2 + length
    while pos < len(cs):
        marker = struct.unpack_from(">H", cs, pos)[0]
        if marker == 0xFFD9:
            out.append(("eoc", cs[pos:]))
            break
        psot = struct.unpack_from(">I", cs, pos + 6)[0]
        end = pos + psot if psot else len(cs) - 2
        sot = cs[pos:pos + 12]
        hp = pos + 12
        hdrs = []
        while struct.unpack_from(">H", cs, hp)[0] != 0xFF93:
            length = struct.unpack_from(">H", cs, hp + 2)[0]
            hdrs.append(cs[hp:hp + 2 + length])
            hp += 2 + length
        out.append(("tp", sot, hdrs, cs[hp + 2:end]))
        pos = end
    return out


def assemble(segs) -> bytes:
    out = b"\xff\x4f"
    for s in segs:
        if s[0] == "tp":
            _, sot, hdrs, data = s
            body = b"".join(hdrs) + b"\xff\x93" + data
            out += sot[:6] + struct.pack(">I", 12 + len(body)) + sot[10:12] \
                + body
        elif s[0] == "eoc":
            out += s[1]
        else:
            out += s[1]
    return out


def split_packets(data: bytes) -> list:
    """A tile-part's data written with SOP and EPH: [(header, body)], the
    header with its EPH, the SOP dropped."""
    out = []
    pos = 0
    while pos < len(data):
        assert data[pos:pos + 2] == b"\xff\x91", pos
        eph = data.index(b"\xff\x92", pos + 6)
        nxt = data.find(b"\xff\x91", eph + 2)
        nxt = len(data) if nxt < 0 else nxt
        out.append((data[pos + 6:eph + 2], data[eph + 2:nxt]))
        pos = nxt
    return out


def packed_headers(cs: bytes, where: str, chunk: int = 60,
                   zppt_per_part: bool = False) -> bytes:
    """The codestream (written with SOP and EPH) with its packet headers
    moved into PPM segments of the main header ("ppm") or PPT segments of
    each tile-part header ("ppt"), chunk bytes a segment at most (an Nppm
    field may be split across two PPM segments); the SOP markers stay in
    the packets' data. Zppt counts on through a tile's tile-parts, or
    starts again at each (zppt_per_part, which OpenJPEG refuses)."""
    segs = segments(cs)
    headers, parts = [], []
    for s in segs:
        if s[0] != "tp":
            continue
        packets = split_packets(s[3])
        hdr = b"".join(h for h, _ in packets)
        nsop = 0
        body = b""
        for h, b in packets:
            body += b"\xff\x91" + struct.pack(">HH", 4, nsop & 0xFFFF) + b
            nsop += 1
        headers.append(hdr)
        parts.append((s[1], [x for x in s[2] if x[:2] != b"\xff\x58"], body))
    out = []
    if where == "ppm":
        stream = b"".join(struct.pack(">I", len(h)) + h for h in headers)
        ppm = []
        for z, at in enumerate(range(0, len(stream), chunk)):
            piece = stream[at:at + chunk]
            ppm.append((0xFF60, struct.pack(">HHB", 0xFF60, 3 + len(piece),
                                            z) + piece))
        main = [s for s in segs if s[0] not in ("tp", "eoc") and
                s[0] not in (0xFF55, 0xFF57)]
        out = main + ppm
        for sot, hdrs, body in parts:
            out.append(("tp", sot, hdrs, body))
    else:
        out = [s for s in segs if s[0] not in ("tp", "eoc") and
               s[0] not in (0xFF55, 0xFF57)]
        next_z = {}
        for (sot, hdrs, body), h in zip(parts, headers):
            tile = sot[4:6]
            z0 = 0 if zppt_per_part else next_z.get(tile, 0)
            ppt = [struct.pack(">HHB", 0xFF61, 3 + len(h[at:at + chunk]),
                               z0 + z) + h[at:at + chunk]
                   for z, at in enumerate(range(0, len(h), chunk))]
            next_z[tile] = z0 + len(ppt)
            out.append(("tp", sot, hdrs + ppt, body))
    out.append(("eoc", b"\xff\xd9"))
    return assemble(out)


def patch(data: bytes, at: int, new: bytes) -> bytes:
    return data[:at] + new + data[at + len(new):]


def marker_at(cs: bytes, marker: int, nth: int = 0) -> int:
    """The offset of the nth marker segment with this marker in the main
    header or the tile-part headers."""
    seen = 0
    for pos in range(len(cs) - 1):
        if cs[pos] == 0xFF and cs[pos + 1] == marker & 0xFF:
            if seen == nth:
                return pos
            seen += 1
    raise ValueError(hex(marker))


# -- the cases ----------------------------------------------------------------

def _pillow(arr, mode=None, **kw) -> bytes:
    from PIL import Image

    b = io.BytesIO()
    im = Image.fromarray(arr, mode) if mode is None else \
        Image.frombytes(mode, (arr.shape[1], arr.shape[0]), arr.tobytes())
    im.save(b, "JPEG2000", **kw)
    return b.getvalue()


def _pillow_cases(out: dict):
    rgb = picture(1, 29, 37).astype(np.uint8)
    grey = rgb[..., 0].copy()
    modes = {"L": grey, "LA": np.ascontiguousarray(rgb[..., :2]),
             "RGB": rgb, "RGBA": np.concatenate([rgb, rgb[..., :1] ^ 0x5A],
                                                -1)}
    i16 = (picture(2, 29, 37, 1, 65536)[..., 0]).astype("<u2")
    for mode, arr in modes.items():
        m = None if mode != "LA" else "LA"
        for rev in ("rev", "irr"):
            kw = {"irreversible": rev == "irr"}
            ext = ".jp2"
            out[f"pw_{mode.lower()}_{rev}_37x29{ext}"] = _pillow(arr, m, **kw)
            out[f"pw_{mode.lower()}_{rev}_j2k_37x29.j2k"] = _pillow(
                arr, m, no_jp2=True, **kw)
    out["pw_i16_rev_37x29.jp2"] = _pillow(i16, "I;16")
    out["pw_i16_irr_37x29.j2k"] = _pillow(i16, "I;16", irreversible=True,
                                          no_jp2=True)
    for mct in (0, 1):
        for rev in ("rev", "irr"):
            out[f"pw_rgb_mct{mct}_{rev}_37x29.jp2"] = _pillow(
                rgb, mct=mct, irreversible=rev == "irr")
    for n in range(1, 8):
        big = picture(3 + n, 70, 90).astype(np.uint8)
        out[f"pw_rgb_res{n}_90x70.jp2"] = _pillow(big, num_resolutions=n)
        out[f"pw_rgb_res{n}_irr_90x70.jp2"] = _pillow(
            big, num_resolutions=n, irreversible=True,
            quality_layers=[8])
    big = picture(11, 70, 90).astype(np.uint8)
    for cb in ((4, 4), (16, 64), (64, 16), (32, 32)):
        out[f"pw_rgb_cblk{cb[0]}x{cb[1]}_90x70.jp2"] = _pillow(
            big, codeblock_size=cb)
    for prc in ((16, 16), (32, 64), (128, 32)):
        out[f"pw_rgb_prc{prc[0]}x{prc[1]}_90x70.jp2"] = _pillow(
            big, precinct_size=prc, codeblock_size=(8, 8))
    for prog in PROGRESSIONS:
        out[f"pw_rgb_{prog.lower()}_90x70.jp2"] = _pillow(
            big, progression=prog, precinct_size=(32, 32),
            codeblock_size=(16, 16), quality_layers=[20, 8, 2])
        out[f"pw_rgb_{prog.lower()}_tiles_90x70.j2k"] = _pillow(
            big, progression=prog, tile_size=(32, 24), no_jp2=True,
            num_resolutions=3)
    out["pw_rgb_layers_90x70.jp2"] = _pillow(big, quality_layers=[40, 20, 10,
                                                                   5])
    out["pw_rgb_layers_irr_90x70.jp2"] = _pillow(
        big, quality_layers=[30, 10, 3], irreversible=True)
    out["pw_rgb_dbl_layers_90x70.jp2"] = _pillow(
        big, quality_mode="dB", quality_layers=[30, 40, 50])
    out["pw_rgb_tiles_90x70.jp2"] = _pillow(big, tile_size=(32, 32))
    out["pw_rgb_tiles_offsets_90x70.jp2"] = _pillow(
        big, tile_size=(32, 24), tile_offset=(3, 5), offset=(7, 11))
    out["pw_rgb_offset_90x70.jp2"] = _pillow(big, offset=(13, 2),
                                             tile_size=(103, 72))
    out["pw_rgb_tiles_irr_90x70.jp2"] = _pillow(
        big, tile_size=(40, 40), irreversible=True, quality_layers=[10])
    out["pw_rgb_plt_90x70.jp2"] = _pillow(big, plt=True,
                                          quality_layers=[20, 5])
    out["pw_rgb_comment_90x70.j2k"] = _pillow(big, no_jp2=True,
                                              comment="a comment")
    for cinema in ("cinema2k-24", "cinema2k-48", "cinema4k-24"):
        try:
            out[f"pw_rgb_{cinema}_90x70.j2k"] = _pillow(
                big, cinema_mode=cinema, no_jp2=True)
        except OSError:
            pass
    for (w, h) in ((1, 1), (1, 9), (9, 1), (1, 40), (40, 1), (2, 3)):
        a = picture(20 + w + h, h, w).astype(np.uint8)
        out[f"pw_rgb_{w}x{h}.jp2"] = _pillow(a)
        out[f"pw_l_irr_{w}x{h}.jp2"] = _pillow(a[..., 0].copy(),
                                               irreversible=True)


def _grey(seed, h, w, prec, sgnd=False):
    p = picture(seed, h, w, 1, 1 << prec)[..., 0]
    return p - (1 << (prec - 1)) if sgnd else p


def _rgb_planes(seed, h, w, prec=8, sub=((1, 1),) * 3):
    p = picture(seed, h, w, 3, 1 << prec)
    return [p[::s[1], ::s[0], c] for c, s in enumerate(sub)]


def _writer_cases(out: dict):
    rgb = _rgb_planes(30, 33, 41)
    comps8 = [(1, 1, 8, 0)] * 3
    styles = {"bypass": 1, "reset": 2, "termall": 4, "vcausal": 8,
              "pterm": 16, "segsym": 32, "bypass_termall": 5,
              "bypass_vcausal": 9, "reset_segsym": 34, "all": 63,
              "bypass_reset_pterm": 19}
    for name, st in styles.items():
        for rev in ("rev", "irr"):
            out[f"ow_style_{name}_{rev}_41x33.j2k"] = codestream(
                rgb, comps8, style=st, irreversible=rev == "irr",
                mct=1, cblk=(16, 16), rates=(20.0, 8.0, 0.0))
    g = [_grey(31, 45, 38, 8)]
    for name, st in (("vcausal", 8), ("all", 63), ("bypass", 1)):
        out[f"ow_style_{name}_grey_38x45.j2k"] = codestream(
            g, [(1, 1, 8, 0)], style=st, cblk=(8, 8), resolutions=4)
    for scod, name in ((2, "sop"), (4, "eph"), (6, "sop_eph")):
        out[f"ow_{name}_41x33.j2k"] = codestream(
            rgb, comps8, scod=scod, rates=(20.0, 0.0), cblk=(16, 16))
    out["ow_poc_41x33.j2k"] = codestream(
        rgb, comps8, resolutions=3, rates=(20.0, 5.0, 0.0),
        pocs=((1, 0, 0, 2, 2, 3, 1), (1, 0, 0, 3, 3, 3, 4)))
    out["ow_poc_tiles_41x33.j2k"] = codestream(
        rgb, comps8, resolutions=3, tiles=(24, 16), rates=(10.0, 0.0),
        pocs=((1, 0, 0, 1, 3, 2, 0), (1, 0, 2, 2, 3, 3, 2),
              (2, 0, 0, 2, 3, 3, 3)))
    for shift, name in ((5, "rgn5"), (20, "rgn20")):
        out[f"ow_{name}_41x33.j2k"] = codestream(
            rgb, comps8, roi=(0, shift), cblk=(16, 16))
    out["ow_rgn_irr_41x33.j2k"] = codestream(
        rgb, comps8, roi=(1, 7), irreversible=True, mct=1)
    # subsampling: 4:2:0 and 4:2:2 chroma, a subsampled first component
    for sub, name in ((((1, 1), (2, 2), (2, 2)), "420"),
                      (((1, 1), (2, 1), (2, 1)), "422"),
                      (((2, 2), (1, 1), (1, 1)), "first"),
                      (((1, 1), (1, 1), (3, 2)), "third")):
        planes = _rgb_planes(32, 34, 42, sub=sub)
        comps = [(s[0], s[1], 8, 0) for s in sub]
        out[f"ow_sub{name}_42x34.j2k"] = codestream(planes, comps)
        out[f"ow_sub{name}_sycc_42x34.jp2"] = codestream(
            planes, comps, codec=2, color_space=3)
        out[f"ow_sub{name}_srgb_42x34.jp2"] = codestream(
            planes, comps, codec=2, color_space=1)
    # a component with no samples in some tiles: Pillow's unpacker reads
    # the zeroed buffer past the tile's data there
    out["ow_sub_empty_tiles_42x34.j2k"] = codestream(
        _rgb_planes(38, 34, 42, sub=((1, 1), (1, 1), (8, 1))),
        [(1, 1, 8, 0), (1, 1, 8, 0), (8, 1, 8, 0)], tiles=(5, 9),
        resolutions=2)
    p4 = _rgb_planes(33, 34, 42, sub=((1, 1), (2, 2), (2, 2))) + \
        [picture(34, 34, 42, 1)[..., 0]]
    out["ow_sub420_alpha_42x34.j2k"] = codestream(
        p4, [(1, 1, 8, 0), (2, 2, 8, 0), (2, 2, 8, 0), (1, 1, 8, 0)])
    out["ow_sub_offsets_42x34.j2k"] = codestream(
        _rgb_planes(35, 17, 21, sub=((2, 2),) * 3), [(2, 2, 8, 0)] * 3,
        offset=(5, 3))
    # signed components and every precision
    for prec in range(1, 17):
        out[f"ow_grey_p{prec}_23x19.j2k"] = codestream(
            [_grey(40 + prec, 19, 23, prec)], [(1, 1, prec, 0)])
        out[f"ow_grey_p{prec}_23x19.jp2"] = codestream(
            [_grey(60 + prec, 19, 23, prec)], [(1, 1, prec, 0)], codec=2,
            color_space=2)
    for prec in (1, 4, 8, 12, 16):
        out[f"ow_grey_p{prec}_signed_23x19.j2k"] = codestream(
            [_grey(80 + prec, 19, 23, prec, True)], [(1, 1, prec, 1)])
        out[f"ow_rgb_p{prec}_signed_23x19.j2k"] = codestream(
            _rgb_planes(90 + prec, 19, 23, prec), [(1, 1, prec, 1)] * 3,
            irreversible=prec > 4)
    for prec in (2, 5, 10, 12, 16):
        out[f"ow_rgb_p{prec}_23x19.jp2"] = codestream(
            _rgb_planes(100 + prec, 19, 23, prec), [(1, 1, prec, 0)] * 3,
            codec=2, color_space=1, mct=1)
        out[f"ow_la_p{prec}_23x19.j2k"] = codestream(
            [_grey(110 + prec, 19, 23, prec), _grey(120 + prec, 19, 23, 8)],
            [(1, 1, prec, 0), (1, 1, 8, 0)])
    out["ow_la_subsampled_42x34.j2k"] = codestream(
        [_grey(134, 34, 42, 8), _grey(135, 34, 42, 8)[::2, ::2]],
        [(1, 1, 8, 0), (2, 2, 8, 0)])
    out["ow_rgba_mixed_prec_23x19.j2k"] = codestream(
        [_grey(130, 19, 23, 12), _grey(131, 19, 23, 4),
         _grey(132, 19, 23, 16), _grey(133, 19, 23, 1)],
        [(1, 1, 12, 0), (1, 1, 4, 0), (1, 1, 16, 0), (1, 1, 1, 0)])
    # tile-parts, odd offsets (the DWT's odd starts), precincts
    for flag in "RLC":
        out[f"ow_tileparts_{flag}_41x33.j2k"] = codestream(
            rgb, comps8, tiles=(20, 20), tile_parts=flag,
            rates=(20.0, 8.0, 0.0), resolutions=3)
    for off in ((1, 0), (0, 1), (3, 5), (1, 1)):
        out[f"ow_offset{off[0]}_{off[1]}_41x33.j2k"] = codestream(
            rgb, comps8, offset=off, resolutions=4, irreversible=off[1] > 0)
    out["ow_offset_tiles_41x33.j2k"] = codestream(
        rgb, comps8, offset=(7, 9), tiles=(16, 16), tile_offset=(5, 2),
        resolutions=3, irreversible=True, mct=1)
    out["ow_odd_1x9.j2k"] = codestream([_grey(140, 9, 1, 8)], [(1, 1, 8, 0)],
                                       offset=(3, 1))
    out["ow_odd_9x1.j2k"] = codestream([_grey(141, 1, 9, 8)], [(1, 1, 8, 0)],
                                       offset=(1, 3), irreversible=True)
    out["ow_precincts_41x33.j2k"] = codestream(
        rgb, comps8, precincts=((5, 4), (4, 4), (3, 5), (2, 2)),
        resolutions=4, cblk=(8, 8), progression="RPCL",
        rates=(10.0, 0.0))
    out["ow_precincts_pcrl_sub_42x34.j2k"] = codestream(
        _rgb_planes(36, 34, 42, sub=((1, 1), (2, 2), (2, 1))),
        [(1, 1, 8, 0), (2, 2, 8, 0), (2, 1, 8, 0)],
        precincts=((4, 4), (3, 3), (2, 3)), resolutions=3, cblk=(4, 4),
        progression="PCRL")
    out["ow_cprl_sub_42x34.j2k"] = codestream(
        _rgb_planes(37, 34, 42, sub=((1, 1), (2, 2), (2, 2))),
        [(1, 1, 8, 0), (2, 2, 8, 0), (2, 2, 8, 0)],
        precincts=((4, 4), (3, 3)), resolutions=3, cblk=(4, 4),
        progression="CPRL", tiles=(24, 20))
    # Part 2's multi-component transform: left to others
    out["mct_part2_41x33.j2k"] = codestream(
        rgb, comps8, custom_mct=True, irreversible=True)


def _jp2_box_cases(out: dict):
    g = codestream([_grey(150, 21, 27, 8)], [(1, 1, 8, 0)])
    ga = codestream([_grey(151, 21, 27, 8), _grey(152, 21, 27, 8)],
                    [(1, 1, 8, 0)] * 2)
    rgb = codestream(_rgb_planes(153, 21, 27), [(1, 1, 8, 0)] * 3)
    cmyk = codestream([_grey(154 + c, 21, 27, 8) for c in range(4)],
                      [(1, 1, 8, 0)] * 4)
    rng = np.random.default_rng(160)
    pal = rng.integers(0, 256, (256, 3))
    out["jb_cmyk_27x21.jp2"] = wrap(cmyk, 12)
    out["jb_rgba_27x21.jp2"] = wrap(cmyk, 16)
    out["jb_rgba_grey_colr_27x21.jp2"] = wrap(cmyk, 17)
    out["jb_p_27x21.jp2"] = wrap(g, 16, [pclr(pal, [7, 7, 7]), cmap([0, 1, 2])])
    out["jb_p_rgba_palette_27x21.jp2"] = wrap(
        g, 16, [pclr(np.concatenate([pal, pal[:, :1]], 1), [7] * 4),
                cmap([0, 1, 2, 3])])
    out["jb_p_one_column_27x21.jp2"] = wrap(g, 16, [pclr(pal[:, :1], [7]),
                                                    cmap([0])])
    dup = pal.copy()
    dup[10:40] = dup[0]
    out["jb_p_duplicates_27x21.jp2"] = wrap(g, 16, [pclr(dup, [7, 7, 7])])
    out["jb_p_short_27x21.jp2"] = wrap(g, 16, [pclr(pal[:40], [7, 7, 7])])
    out["jb_p_9bit_27x21.jp2"] = wrap(g, 16, [pclr(pal * 2, [8, 8, 8])])
    out["jb_p_16bit_27x21.jp2"] = wrap(g, 16, [pclr(pal * 250, [15, 15, 15])])
    out["jb_p_grey_colr_27x21.jp2"] = wrap(g, 17, [pclr(pal, [7, 7, 7])])
    out["jb_pa_27x21.jp2"] = wrap(ga, 16, [pclr(pal, [7, 7, 7])])
    out["jb_pa_grey_27x21.jp2"] = wrap(ga, 17, [pclr(pal, [7, 7, 7])])
    many = np.stack([np.arange(300) % 256, np.arange(300) // 256,
                     np.zeros(300, int)], 1)
    out["jb_p_257_colours_27x21.jp2"] = wrap(g, 16, [pclr(many, [7, 7, 7])])
    out["jb_rgb_grey_colr_27x21.jp2"] = wrap(rgb, 17)
    out["jb_rgb_sycc_27x21.jp2"] = wrap(rgb, 18)
    out["jb_rgb_eycc_27x21.jp2"] = wrap(rgb, 24)
    out["jb_rgb_cielab_27x21.jp2"] = wrap(rgb, 14)
    out["jb_rgb_enumcs_99_27x21.jp2"] = wrap(rgb, 99)
    s = siz_of(rgb)
    hd = ihdr(s["w"], s["h"], 3, 7)
    out["jb_rgb_icc_27x21.jp2"] = jp2(rgb, [hd, box(b"colr", b"\x02\x00\x00"
                                                        + bytes(40))])
    out["jb_rgb_no_colr_27x21.jp2"] = jp2(rgb, [hd])
    out["jb_rgb_colr_meth3_27x21.jp2"] = jp2(
        rgb, [hd, box(b"colr", b"\x03\x00\x00" + bytes(4)), colr(16)])
    out["jb_rgb_two_colr_27x21.jp2"] = jp2(rgb, [hd, colr(17), colr(16)])
    out["jb_rgb_colr_first_27x21.jp2"] = jp2(rgb, [colr(16), hd])
    out["jb_rgb_res_27x21.jp2"] = jp2(rgb, [hd, colr(16), box(
        b"res ", box(b"resc", struct.pack(">HHHHBB", 1, 1, 1, 1, 2, 2)))])
    out["jb_rgb_bpcc_27x21.jp2"] = jp2(rgb, [
        ihdr(s["w"], s["h"], 3, 255), colr(16), box(b"bpcc", b"\x07" * 3)])
    out["jb_rgb_bad_bpcc_27x21.jp2"] = jp2(rgb, [
        ihdr(s["w"], s["h"], 3, 255), colr(16), box(b"bpcc", b"\x07" * 2)])
    out["jb_ihdr_wider_27x21.jp2"] = jp2(rgb, [ihdr(s["w"] + 1, s["h"], 3, 7),
                                               colr(16)])
    out["jb_ihdr_nc1_rgb_27x21.jp2"] = jp2(rgb, [ihdr(s["w"], s["h"], 1, 7),
                                                 colr(17)])
    out["jb_ihdr_nc3_grey_27x21.jp2"] = jp2(g, [ihdr(s["w"], s["h"], 3, 7),
                                                colr(17)])
    out["jb_ihdr_nc4_grey_27x21.jp2"] = jp2(ga, [ihdr(s["w"], s["h"], 4, 7),
                                                 colr(17)])
    out["jb_ihdr_bpc12_grey_27x21.jp2"] = jp2(g, [ihdr(s["w"], s["h"], 1, 11),
                                                  colr(17)])
    out["jb_two_ihdr_27x21.jp2"] = jp2(rgb, [hd, ihdr(5, 5, 1, 7), colr(16)])
    out["jb_unknown_boxes_27x21.jp2"] = jp2(
        rgb, [hd, box(b"xyzw", b"12345"), colr(16)],
        before=[box(b"uuid", bytes(20))], after=[box(b"xml ", b"<a/>")])
    out["jb_box_after_cut_27x21.jp2"] = wrap(rgb, 16) + box(
        b"xml ", b"<a/>" * 4)[:-5]
    out["jb_box_after_short_len_27x21.jp2"] = wrap(rgb, 16) + \
        struct.pack(">I", 4) + b"free" + bytes(6)
    out["jb_box_after_zero_len_27x21.jp2"] = wrap(rgb, 16) + \
        struct.pack(">I", 0) + b"free" + bytes(6)
    out["jb_jp2c_first_27x21.jp2"] = (
        JP2_SIGNATURE + FTYP + box(b"jp2c", rgb) +
        box(b"jp2h", hd + colr(16)))
    out["jb_jpx_brand_27x21.jp2"] = jp2(
        rgb, [hd, colr(16)], ftyp=box(b"ftyp", b"jpx " + bytes(4) + b"jpx "))
    out["jb_xl_box_27x21.jp2"] = (
        JP2_SIGNATURE + FTYP + box(b"jp2h", hd + colr(16)) +
        struct.pack(">I", 1) + b"jp2c" + struct.pack(">Q", 16 + len(rgb)) +
        rgb)
    # a length past 2^32 ends OpenJPEG's box walk: the codestream is read
    # from where the stream stands
    out["jb_xl_box_high_27x21.jp2"] = (
        JP2_SIGNATURE + FTYP + box(b"jp2h", hd + colr(16)) +
        struct.pack(">I", 1) + b"jp2c" + struct.pack(">Q", (1 << 32) + 16 +
                                                     len(rgb)) + rgb)
    out["jb_jp2c_len0_27x21.jp2"] = (
        JP2_SIGNATURE + FTYP + box(b"jp2h", hd + colr(16)) +
        struct.pack(">I", 0) + b"jp2c" + rgb)
    out["jb_no_jp2h_27x21.jp2"] = JP2_SIGNATURE + FTYP + box(b"jp2c", rgb)
    out["jb_empty_jp2h_27x21.jp2"] = (JP2_SIGNATURE + FTYP +
                                      box(b"jp2h", b"") + box(b"jp2c", rgb))
    out["jb_short_ihdr_27x21.jp2"] = jp2(rgb, [hd[:-3] + b"", colr(16)])
    out["jb_bad_ftyp_27x21.jp2"] = jp2(rgb, [hd, colr(16)],
                                       ftyp=box(b"ftyp", b"jp2 " + bytes(5)))


def _damaged_cases(out: dict):
    rgb = _rgb_planes(170, 25, 31)
    comps8 = [(1, 1, 8, 0)] * 3
    cs = codestream(rgb, comps8, rates=(20.0, 0.0))
    tiled = codestream(rgb, comps8, tiles=(16, 16), rates=(20.0, 0.0))
    out["dm_no_eoc_31x25.j2k"] = cs[:-2]
    out["dm_no_eoc_31x25.jp2"] = wrap(cs[:-2])
    out["dm_eoc_then_bytes_31x25.j2k"] = cs + b"\x00" * 7
    out["dm_garbage_after_31x25.j2k"] = cs[:-2] + b"\x12\x34\x56\x78"
    for cut in (0.3, 0.7, 0.95):
        at = int(len(cs) * cut)
        out[f"dm_cut{int(cut * 100)}_31x25.j2k"] = cs[:at]
    out["dm_cut_tiled_31x25.j2k"] = tiled[:int(len(tiled) * 0.6)]
    out["dm_cut_in_main_header_31x25.j2k"] = cs[:60]
    sot = marker_at(cs, 0xFF90)
    out["dm_psot0_31x25.j2k"] = patch(cs, sot + 6, b"\x00\x00\x00\x00")
    out["dm_psot0_no_eoc_31x25.j2k"] = patch(cs, sot + 6,
                                             b"\x00\x00\x00\x00")[:-2]
    psot = struct.unpack_from(">I", cs, sot + 6)[0]
    out["dm_psot_short_31x25.j2k"] = patch(cs, sot + 6,
                                           struct.pack(">I", psot - 9))
    out["dm_psot_long_31x25.j2k"] = patch(cs, sot + 6,
                                          struct.pack(">I", psot + 9))
    out["dm_psot13_31x25.j2k"] = patch(cs, sot + 6, struct.pack(">I", 13))
    tsot = [marker_at(tiled, 0xFF90, k) for k in range(4)]
    out["dm_tile_psot0_31x25.j2k"] = patch(tiled, tsot[3] + 6, bytes(4))
    out["dm_tile_index_past_31x25.j2k"] = patch(tiled, tsot[1] + 4,
                                                b"\x00\x09")
    out["dm_tile_twice_31x25.j2k"] = patch(tiled, tsot[1] + 4, b"\x00\x00")
    out["dm_tnsot0_31x25.j2k"] = patch(patch(tiled, tsot[0] + 11, b"\x00"),
                                       tsot[2] + 11, b"\x00")
    out["dm_tpsot1_31x25.j2k"] = patch(tiled, tsot[0] + 10, b"\x01")
    sod = cs.index(b"\xff\x93", sot)
    # packet data: a length past the tile-part's data, and changed bytes
    out["dm_packet_bytes_31x25.j2k"] = patch(cs, sod + 2, b"\xff\xff\xff")
    out["dm_packet_zeroes_31x25.j2k"] = patch(cs, sod + 2, bytes(3))
    mid = sod + (len(cs) - sod) // 2
    out["dm_flip_mid_31x25.j2k"] = patch(cs, mid, bytes([cs[mid] ^ 0x10]))
    siz = marker_at(cs, 0xFF51)
    out["dm_siz_dx0_31x25.j2k"] = patch(cs, siz + 41 + 1, b"\x00")
    out["dm_siz_tile0_31x25.j2k"] = patch(cs, siz + 20, bytes(4))
    out["dm_siz_csiz5_31x25.j2k"] = patch(cs, siz + 38, b"\x00\x05")
    out["dm_siz_offset_past_31x25.j2k"] = patch(cs, siz + 14,
                                                struct.pack(">I", 40))
    cod = marker_at(cs, 0xFF52)
    out["dm_cod_cblk_31x25.j2k"] = patch(cs, cod + 10, b"\x09\x09")
    out["dm_cod_layers0_31x25.j2k"] = patch(cs, cod + 6, b"\x00\x00")
    out["dm_cod_prog7_31x25.j2k"] = patch(cs, cod + 5, b"\x07")
    out["dm_cod_mct2_31x25.j2k"] = patch(cs, cod + 8, b"\x02")
    out["dm_cod_res40_31x25.j2k"] = patch(cs, cod + 9, b"\x27")
    out["dm_cod_qmfb2_31x25.j2k"] = patch(cs, cod + 13, b"\x02")
    qcd = marker_at(cs, 0xFF5C)
    out["dm_qcd_guard7_31x25.j2k"] = patch(cs, qcd + 4,
                                           bytes([cs[qcd + 4] | 0xE0]))
    out["dm_no_cod_31x25.j2k"] = patch(cs, cod, b"\xff\x64")
    out["dm_unknown_marker_31x25.j2k"] = cs[:cod] + b"\xff\x30" + \
        b"\x00\x04\x00\x00" + cs[cod:]
    out["dm_unknown_segment_31x25.j2k"] = cs[:cod] + b"\xff\x6f\x00\x04" \
        b"\x12\x34" + cs[cod:]
    out["dm_eoc_in_header_31x25.j2k"] = cs[:cod] + b"\xff\xd9" + cs[cod:]
    out["dm_sop_in_header_31x25.j2k"] = cs[:cod] + b"\xff\x91\x00\x04" \
        b"\x00\x00" + cs[cod:]
    out["dm_cod_twice_31x25.j2k"] = cs[:qcd] + cs[cod:cod + 2 + struct.unpack_from(
        ">H", cs, cod + 2)[0]] + cs[qcd:]
    out["dm_siz_second_31x25.j2k"] = cs[:cod] + cs[siz:siz + 49] + cs[cod:]
    # scalar derived quantisation (one step size for every band)
    irr = codestream(rgb, comps8, irreversible=True, rates=(10.0,))
    q = marker_at(irr, 0xFF5C)
    qlen = struct.unpack_from(">H", irr, q + 2)[0]
    derived = struct.pack(">HHB", 0xFF5C, 5, (irr[q + 4] & 0xE0) | 1) + \
        irr[q + 5:q + 7]
    out["dm_qcd_derived_31x25.j2k"] = irr[:q] + derived + irr[q + 2 + qlen:]
    # a packet's EPH replaced
    sop_eph = codestream(rgb, comps8, scod=6, rates=(20.0, 0.0))
    eph = sop_eph.index(b"\xff\x92", marker_at(sop_eph, 0xFF93))
    out["dm_eph_missing_31x25.j2k"] = patch(sop_eph, eph, b"\xff\x00")
    # a POC's progression past CPRL: that POC yields no packets
    poc = codestream(rgb, comps8, resolutions=3, rates=(20.0, 0.0),
                     pocs=((1, 0, 0, 2, 2, 3, 1), (1, 0, 0, 2, 3, 3, 4)))
    pp = marker_at(poc, 0xFF5F)
    out["dm_poc_order7_31x25.j2k"] = patch(poc, pp + 4 + 6, b"\x07")


def _packed_cases(out: dict):
    rgb = _rgb_planes(180, 27, 35)
    comps8 = [(1, 1, 8, 0)] * 3
    base = codestream(rgb, comps8, scod=6, rates=(15.0, 4.0, 0.0),
                      resolutions=3, cblk=(8, 8))
    tiled = codestream(rgb, comps8, scod=6, rates=(15.0, 0.0),
                       resolutions=3, tiles=(16, 16), tile_parts="R")
    out["pp_sop_eph_35x27.j2k"] = base
    out["pp_ppm_35x27.j2k"] = packed_headers(base, "ppm")
    out["pp_ppm_one_35x27.j2k"] = packed_headers(base, "ppm", 60000)
    out["pp_ppt_35x27.j2k"] = packed_headers(base, "ppt")
    out["pp_ppm_tileparts_35x27.j2k"] = packed_headers(tiled, "ppm", 60000)
    out["pp_ppm_split_nppm_35x27.j2k"] = packed_headers(tiled, "ppm", 37)
    out["pp_ppt_tileparts_35x27.j2k"] = packed_headers(tiled, "ppt", 23)
    out["pp_ppt_zppt_again_35x27.j2k"] = packed_headers(
        tiled, "ppt", 23, zppt_per_part=True)
    out["pp_ppm_35x27.jp2"] = wrap(packed_headers(base, "ppm"))
    ppm = packed_headers(base, "ppm")
    at = marker_at(ppm, 0xFF60)
    out["pp_ppm_short_nppm_35x27.j2k"] = patch(ppm, at + 5,
                                               b"\x00\x00\x00\x05")
    out["pp_ppm_zppm_twice_35x27.j2k"] = patch(
        ppm, marker_at(ppm, 0xFF60, 1) + 4, b"\x00")
    ppt = packed_headers(base, "ppt")
    out["pp_ppt_and_ppm_35x27.j2k"] = ppt[:marker_at(ppt, 0xFF90)] + \
        ppm[at:at + 2 + struct.unpack_from(">H", ppm, at + 2)[0]] + \
        ppt[marker_at(ppt, 0xFF90):]


def _ht_cases(out: dict):
    rgb = _rgb_planes(190, 21, 27)
    cs = codestream(rgb, [(1, 1, 8, 0)] * 3)
    cod = marker_at(cs, 0xFF52)
    out["ht_cod_27x21.j2k"] = patch(cs, cod + 12, bytes([cs[cod + 12] | 0x40]))
    out["ht_cod_27x21.jp2"] = wrap(patch(cs, cod + 12,
                                         bytes([cs[cod + 12] | 0x40])))
    coc = b"\xff\x53\x00\x09\x01\x00" + cs[cod + 9:cod + 12] + \
        bytes([0x40]) + cs[cod + 13:cod + 14]
    qcd = marker_at(cs, 0xFF5C)
    out["ht_coc_27x21.j2k"] = cs[:qcd] + coc + cs[qcd:]
    sod = cs.index(b"\xff\x93", marker_at(cs, 0xFF90))
    tcod = cs[cod:cod + 2 + struct.unpack_from(">H", cs, cod + 2)[0]]
    tcod = patch(tcod, 12, bytes([tcod[12] | 0x40]))
    tp = cs[:sod] + tcod + cs[sod:]
    sot = marker_at(tp, 0xFF90)
    psot = struct.unpack_from(">I", tp, sot + 6)[0]
    out["ht_tile_cod_27x21.j2k"] = patch(tp, sot + 6,
                                         struct.pack(">I", psot + len(tcod)))


def scene_cases(rgb: np.ndarray) -> dict:
    """The 640x480 scene in the four settings of phase 9r. Pillow reads
    12-bit grey as I;16 shifted left by 4, which convert("RGB") clips at
    255: the grey scene stores the luma's top 4 bits (luma >> 4), which
    come out as luma & 0xF0."""
    grey12 = rgb.astype(np.int64) @ np.array([299, 587, 114]) // 1000 >> 4
    return {
        SCENES[0]: _pillow(rgb),
        SCENES[1]: _pillow(rgb, irreversible=True, mct=1,
                           quality_layers=[12]),
        SCENES[2]: _pillow(rgb, tile_size=(256, 256), irreversible=True,
                           quality_layers=[16]),
        SCENES[3]: codestream([grey12], [(1, 1, 12, 0)], resolutions=6),
    }


def cases() -> dict:
    """Every committed file."""
    torch_jpeg_fixtures = _sibling("torch_jpeg_fixtures")
    import warnings

    warnings.simplefilter("ignore")
    out = {}
    _pillow_cases(out)
    _writer_cases(out)
    _jp2_box_cases(out)
    _damaged_cases(out)
    _packed_cases(out)
    _ht_cases(out)
    out.update(scene_cases(torch_jpeg_fixtures.scene(0)))
    return out


def load(folder: str = FOLDER, name: str = DIGESTS) -> dict:
    with open(os.path.join(folder, name)) as f:
        return json.load(f)


def write(folder: str = FOLDER) -> dict:
    """Write every case and digests.json into folder; returns the
    digests."""
    import warnings

    tc = _sibling("torch_tiff_corpus")
    warnings.simplefilter("ignore")
    os.makedirs(folder, exist_ok=True)
    for old in os.listdir(folder):
        if old.endswith((".jp2", ".j2k")):
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
    return None if img is None else hashlib.sha256(
        np.ascontiguousarray(img).tobytes()).hexdigest()


if __name__ == "__main__":
    print(json.dumps(write(*sys.argv[1:]), indent=1, sort_keys=True))
