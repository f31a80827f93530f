"""The BCn corpus (tests/fixtures/torch_bcn_corpus/): DDS, BLP and FTEX
files, which the JAX package hands to Pillow 12.1.0 and the port reads in
data/bcn.py (the block loops in csrc/bcn_decode.cc).

Small files made from numpy seeds (file names give the width before the
height; each name starts with its format):

- Pillow's writers, in round trips: DDS DXT1, DXT3, DXT5, BC2, BC3 and BC5,
  and DDS's uncompressed RGB, RGBA, L and LA; BLP1 and BLP2 palettes, with
  and without alpha;
- written here, what the writers never emit: DX10 files of every DXGI
  format Pillow reads (BC1-BC7, BC5 and BC6H signed, R8G8B8A8 and its
  typeless and sRGB forms) and the legacy FourCCs, over random blocks
  (every BC7 mode and a first byte of 0, every BC6H mode code, reserved
  ones included); RGB masks at 8, 16, 24, 32 and 40 bits, gapped and empty
  masks, files cut inside the pixels (read as zeros); P with its RGBA
  palette; BLP2 DXT1, DXT3 and DXT5 with the alpha flag both ways at widths
  1, 5, 6 and 7; BLP1 JPEG in YCbCr, grey, CMYK and YCCK, with skips
  forward and back; FTEX with formats 0 and 1;
- cut files, and headers each open passes on or refuses (an FTEX header
  that passes its file on to SPIDER among them).

``digests.json`` holds, for each file, the sha256 of each JAX route's
pixels on this machine, null where it fails, and the (h, w) Pillow's open
reads (tests/torch_tiff_corpus.py:reference), the made scenes' too: the
640x480 scene (tests/torch_jpeg_fixtures.py:scene 0) as DDS DXT1, BC7
(mode 6 blocks), BC6H (unsigned, mode 11 blocks) and RGB565, BLP2 DXT5,
BLP1 palette and FTEX DXT1, made by ``made()`` with numpy alone
(chip_smoke.py's 9t makes them on the card). This module imports neither
Pillow nor another test module until ``write`` runs. Remake the corpus
(Pillow and the JAX package needed) with

  python -m tests.torch_bcn_corpus [folder]
"""

import hashlib
import io
import json
import os
import struct
import sys

import numpy as np

FOLDER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                      "torch_bcn_corpus")
DIGESTS = "digests.json"
SCENES = ("scene_dds_dxt1_640x480.dds", "scene_dds_bc7_640x480.dds",
          "scene_dds_bc6h_640x480.dds", "scene_dds_rgb565_640x480.dds",
          "scene_blp2_dxt5_640x480.blp", "scene_blp1_palette_640x480.blp",
          "scene_ftex_dxt1_640x480.ftc")
MADE = SCENES
# chip_smoke.py's 9t: no scene under an Orientation (detect --img reads
# the rate scene), and no file is left to PIL
ROTATED = None
LEFT_TO_PIL = ()

# DDPF flags and the DX10 FourCC
ALPHAPIXELS, FOURCC, PAL8, RGB, LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000
# "bcn" decoder n -> bytes a block
BLOCK = {1: 8, 2: 16, 3: 16, 4: 8, 5: 16, 6: 16, 7: 16}


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


def picture(seed: int, h: int, w: int, channels: int = 3) -> np.ndarray:
    """A smooth picture with noise: block colours are worth encoding."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 255) // max(w - 1, 1), (y * 255) // max(h - 1, 1),
                     ((x + y) * 127) // max(w + h - 2, 1), 255 - (x * 255) //
                     max(w - 1, 1)], -1)[..., :channels]
    return np.clip(base + rng.integers(-24, 25, (h, w, channels)), 0,
                   255).astype(np.uint8)


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

def dds(w: int, h: int, pfflags: int, body: bytes = b"",
        fourcc: bytes = b"\0\0\0\0", bitcount: int = 0, masks=(0, 0, 0, 0),
        dxgi: int = None, header_size: int = 124) -> bytes:
    """A DDS: its 128-byte header (DX10's 20 more where dxgi), then
    body."""
    head = b"DDS " + struct.pack("<7I", header_size, 0x1007, h, w, 0, 0,
                                 0) + bytes(44)
    head += struct.pack("<2I", 32, pfflags) + fourcc + struct.pack(
        "<I", bitcount) + struct.pack("<4I", *masks) + struct.pack(
        "<5I", 0x1000, 0, 0, 0, 0)
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + body


def random_blocks(seed: int, count: int, n: int) -> bytes:
    """count random blocks of decoder n; BC7's cycle through its eight
    modes and a first byte of 0, BC6H's through all 32 mode codes."""
    b = np.random.default_rng(seed).integers(0, 256, (count, BLOCK[n]),
                                            np.uint8)
    k = np.arange(count)
    if n == 7:
        mode = k % 9
        bit = np.left_shift(1, np.minimum(mode, 7)).astype(np.uint8)
        low = (bit.astype(np.int64) * 2 - 1).astype(np.uint8)
        b[:, 0] = np.where(mode == 8, 0, (b[:, 0] & ~low) | bit)
    if n == 6:
        b[:, 0] = (b[:, 0] & 0xE0) | (k % 32)
    return b.tobytes()


def small_bc6h(seed: int, count: int) -> bytes:
    """BC6H blocks of mode code 00011 (one region, 10-bit endpoints) whose
    endpoints are small, so that the pixels fall inside [0, 1]."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        ep = rng.integers(0, 480, 6)
        bits = 3
        for k, v in enumerate(ep):
            bits |= int(v) << (5 + 10 * k)
        bits |= (int.from_bytes(rng.bytes(8), "little") >> 1) << 65
        out.append(bits.to_bytes(16, "little"))
    return b"".join(out)


def blp1(w: int, h: int, body: bytes, compression: int = 1, alpha: int = 0,
         encoding: int = 5, offsets=(), lengths=()) -> bytes:
    """A BLP1: its 28-byte header, the mipmap offsets and lengths, body."""
    head = b"BLP1" + struct.pack("<iIIIii", compression, alpha, w, h,
                                 encoding, 0)
    return head + struct.pack("<16I", *offsets, *(0,) * (16 - len(
        offsets))) + struct.pack("<16I", *lengths, *(0,) * (16 - len(
            lengths))) + body


def blp2(w: int, h: int, body: bytes, compression: int = 1,
         encoding: int = 2, alpha: int = 0, alpha_encoding: int = 0,
         offsets=None, lengths=None, palette: bytes = None) -> bytes:
    """A BLP2: its 20-byte header, the offsets and lengths (the first
    mipmap right after the palette by default), the 1024-byte palette,
    body."""
    head = b"BLP2" + struct.pack("<ibbbbII", compression, encoding, alpha,
                                 alpha_encoding, 0, w, h)
    pal = bytes(1024) if palette is None else palette
    offsets = [20 + 128 + len(pal)] if offsets is None else offsets
    lengths = [len(body)] if lengths is None else lengths
    return head + struct.pack("<16I", *offsets, *(0,) * (16 - len(
        offsets))) + struct.pack("<16I", *lengths, *(0,) * (16 - len(
            lengths))) + pal + body


def ftex(w: int, h: int, fmt: int, mipmap: bytes, where: int = 32,
         format_count: int = 1, mipmap_size: int = None) -> bytes:
    """An FTEX: magic, version, size, one mipmap and format_count formats,
    the format and where its mipmap lies; at where, the mipmap's size and
    bytes."""
    head = b"FTEX" + struct.pack("<7i", 1, w, h, 1, format_count, fmt, where)
    size = len(mipmap) if mipmap_size is None else mipmap_size
    return head + struct.pack("<i", size) + mipmap


# -- block encoders (numpy alone: the card makes the scenes too) --------------

def _blocks_of(img: np.ndarray) -> np.ndarray:
    """(n, 16, c) pixels of the 4x4 blocks of an image whose sides are
    multiples of 4, left to right, top to bottom."""
    h, w, c = img.shape
    return img.reshape(h // 4, 4, w // 4, 4, c).transpose(0, 2, 1, 3,
                                                          4).reshape(-1, 16,
                                                                     c)


def _nearest(px: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """(n, 16) index of each pixel's nearest palette colour (n, k, c)."""
    d = ((px[:, :, None, :].astype(np.int64) -
          palette[:, None, :, :].astype(np.int64)) ** 2).sum(-1)
    return d.argmin(-1)


def _pack_indices(idx: np.ndarray, bits: int) -> np.ndarray:
    """(n,) integers of 16 indices of bits bits each, pixel 0 lowest."""
    out = np.zeros(idx.shape[0], np.uint64)
    for k in range(16):
        out |= idx[:, k].astype(np.uint64) << np.uint64(bits * k)
    return out


def dxt1_blocks(rgb: np.ndarray, blp: bool = False) -> np.ndarray:
    """(n, 8) BC1 colour blocks: the box corners of each block's colours
    as 5:6:5 (the first above the second, four colours), each pixel's
    nearest of the four as Pillow's "bcn" (or BLP's, blp) palette gives
    them."""
    px = _blocks_of(rgb).astype(np.int64)
    hi, lo = px.max(1), px.min(1)

    def q(c):
        return (c[:, 0] >> 3) << 11 | (c[:, 1] >> 2) << 5 | c[:, 2] >> 3
    c0, c1 = q(hi), q(lo)
    c1 = np.where(c0 == c1, np.where(c1 > 0, c1 - 1, c1), c1)
    swap = c0 < c1
    c0, c1 = np.where(swap, c1, c0), np.where(swap, c0, c1)

    def rgb565(c):
        r, g, b = (c >> 11) & 31, (c >> 5) & 63, c & 31
        if blp:
            return np.stack([r << 3, g << 2, b << 3], -1)
        return np.stack([r << 3 | r >> 2, g << 2 | g >> 4, b << 3 | b >> 2],
                        -1)
    p0, p1 = rgb565(c0), rgb565(c1)
    pal = np.stack([p0, p1, (2 * p0 + p1) // 3, (p0 + 2 * p1) // 3], 1)
    idx = _nearest(px, pal)
    idx = np.where((c0 == c1)[:, None], 0, idx)
    out = np.zeros((px.shape[0], 8), np.uint8)
    out[:, 0], out[:, 1] = c0 & 255, c0 >> 8
    out[:, 2], out[:, 3] = c1 & 255, c1 >> 8
    lut = _pack_indices(idx, 2)
    for k in range(4):
        out[:, 4 + k] = (lut >> np.uint64(8 * k)) & np.uint64(255)
    return out


def bc7_mode6_blocks(rgb: np.ndarray) -> np.ndarray:
    """(n, 16) BC7 mode 6 blocks: 7-bit box corners with a p-bit of 1
    (alpha 255), 4-bit indices of each pixel's nearest of the 16 colours;
    pixel 0's index below 8 (the endpoints swapped where it is not)."""
    px = _blocks_of(rgb).astype(np.int64)
    e = np.stack([px.max(1) >> 1, px.min(1) >> 1], 1)     # (n, 2, 3)
    full = (e << 1) | 1
    w = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60,
                  64])
    pal = (full[:, :1] * (64 - w)[None, :, None] + full[:, 1:] *
           w[None, :, None] + 32) >> 6
    idx = _nearest(px, pal)
    flip = idx[:, 0] >= 8
    e = np.where(flip[:, None, None], e[:, ::-1], e)
    idx = np.where(flip[:, None], 15 - idx, idx)
    n = px.shape[0]
    value = np.full(n, 1 << 6, dtype=object)
    pos = 7
    fields = []
    for c in range(3):
        for k in range(2):
            fields.append((e[:, k, c], 7))
    ones = np.ones(n, np.int64)
    fields += [(127 * ones, 7), (127 * ones, 7), (ones, 1), (ones, 1)]
    for k in range(16):
        fields.append((idx[:, k], 3 if k == 0 else 4))
    for v, width in fields:
        value = value + (v.astype(object) << pos)
        pos += width
    assert pos == 128
    return np.array([list(int(x).to_bytes(16, "little")) for x in value],
                    np.uint8)


def _bc6h_table() -> np.ndarray:
    """The 8-bit value Pillow's BC6H gives for each unsigned 10-bit
    endpoint (mode 11, a pixel on the endpoint)."""
    v = np.arange(1024, dtype=np.int64)
    unq = np.where(v == 0, 0, np.where(v == 1023, 0xFFFF,
                                       ((v << 16) + 0x8000) >> 10))
    half = ((unq * 31) // 64).astype(np.uint16).view(np.float16).astype(
        np.float32)
    return np.where(half > 1, 255, (half * np.float32(255)).astype(
        np.int64))


def bc6h_mode11_blocks(rgb: np.ndarray) -> np.ndarray:
    """(n, 16) BC6H blocks of mode code 00011 (one region, 10-bit
    unsigned endpoints, 4-bit indices): each channel's box corners as the
    smallest endpoint that reaches its 8-bit value, each pixel's nearest
    of the 16 lerps; pixel 0's index below 8."""
    table = _bc6h_table()
    inverse = np.searchsorted(table, np.arange(256))
    px = _blocks_of(rgb).astype(np.int64)
    e = np.stack([inverse[px.max(1)], inverse[px.min(1)]], 1)   # (n, 2, 3)
    unq = np.where(e == 0, 0, ((e << 16) + 0x8000) >> 10)
    w = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60,
                  64])
    lerp = (unq[:, :1] * (64 - w)[None, :, None] + unq[:, 1:] *
            w[None, :, None]) >> 6
    half = ((lerp * 31) // 64).astype(np.uint16).view(np.float16).astype(
        np.float32)
    pal = np.where(half > 1, 255, (half * np.float32(255)).astype(np.int64))
    idx = _nearest(px, pal)
    flip = idx[:, 0] >= 8
    e = np.where(flip[:, None, None], e[:, ::-1], e)
    idx = np.where(flip[:, None], 15 - idx, idx)
    value = np.full(px.shape[0], 3, dtype=object)
    pos = 5
    fields = [(e[:, 0, c], 10) for c in range(3)] + \
        [(e[:, 1, c], 10) for c in range(3)] + \
        [(idx[:, k], 3 if k == 0 else 4) for k in range(16)]
    for v, width in fields:
        value = value + (v.astype(object) << pos)
        pos += width
    assert pos == 128
    return np.array([list(int(x).to_bytes(16, "little")) for x in value],
                    np.uint8)


def dxt5_blocks(rgb: np.ndarray) -> np.ndarray:
    """(n, 16) DXT5 blocks for BLP2: alpha 255 throughout, colours as
    dxt1_blocks gives them under BLP's palette."""
    colour = dxt1_blocks(rgb, blp=True)
    out = np.zeros((colour.shape[0], 16), np.uint8)
    out[:, 0] = out[:, 1] = 255
    out[:, 8:] = colour
    return out


def palette_image(rgb: np.ndarray):
    """(indices, BGRA palette bytes): rgb on a 6x7x6 colour cube."""
    levels = (6, 7, 6)
    q = [np.rint(rgb[..., c].astype(np.float64) * (levels[c] - 1) /
                 255).astype(np.int64) for c in range(3)]
    idx = (q[0] * 7 + q[1]) * 6 + q[2]
    cube = np.zeros((256, 4), np.uint8)
    r, g, b = np.meshgrid(*(np.arange(k) for k in levels), indexing="ij")
    n = r.size
    cube[:n, 2] = (r.ravel() * 255) // 5
    cube[:n, 1] = (g.ravel() * 255) // 6
    cube[:n, 0] = (b.ravel() * 255) // 5
    cube[:, 3] = 255
    return idx.astype(np.uint8), cube.tobytes()


def rgb565_pixels(rgb: np.ndarray) -> bytes:
    r, g, b = (rgb[..., c].astype(np.uint16) for c in range(3))
    return ((r >> 3) << 11 | (g >> 2) << 5 | b >> 3).astype("<u2").tobytes()


# -- the committed cases ------------------------------------------------------

def _dds_pillow_cases(out: dict):
    rgb = picture(1, 13, 19)
    rgba = picture(2, 13, 19, 4)
    for pf in ("DXT1", "DXT3", "DXT5", "BC2", "BC3"):
        out[f"dds_pillow_{pf.lower()}_rgba_19x13.dds"] = pillow_written(
            rgba, "DDS", pixel_format=pf)
    out["dds_pillow_dxt1_rgb_19x13.dds"] = pillow_written(
        rgb, "DDS", pixel_format="DXT1")
    out["dds_pillow_bc5_rgb_19x13.dds"] = pillow_written(
        rgb, "DDS", pixel_format="BC5")
    out["dds_pillow_dxt1_rgb_16x8.dds"] = pillow_written(
        picture(3, 8, 16), "DDS", pixel_format="DXT1")
    out["dds_pillow_rgb_19x13.dds"] = pillow_written(rgb, "DDS")
    out["dds_pillow_rgba_19x13.dds"] = pillow_written(rgba, "DDS")
    out["dds_pillow_l_19x13.dds"] = pillow_written(rgb, "DDS", "L")
    out["dds_pillow_la_19x13.dds"] = pillow_written(rgba, "DDS", "LA")


def _dds_block_cases(out: dict):
    # (name, DXGI format, n)
    dxgi = [("bc1_typeless", 70, 1), ("bc1", 71, 1), ("bc2_typeless", 73, 2),
            ("bc2", 74, 2), ("bc3_typeless", 76, 3), ("bc3", 77, 3),
            ("bc4_typeless", 79, 4), ("bc4", 80, 4), ("bc5_typeless", 82, 5),
            ("bc5", 83, 5), ("bc5_snorm", 84, 5), ("bc6h_uf16", 95, 6),
            ("bc6h_sf16", 96, 6), ("bc7_typeless", 97, 7), ("bc7", 98, 7),
            ("bc7_srgb", 99, 7)]
    for seed, (name, code, n) in enumerate(dxgi):
        out[f"dds_dx10_{name}_20x12.dds"] = dds(
            20, 12, FOURCC, random_blocks(100 + seed, 15, n), b"DX10",
            dxgi=code)
        out[f"dds_dx10_{name}_13x7.dds"] = dds(
            13, 7, FOURCC, random_blocks(200 + seed, 8, n), b"DX10",
            dxgi=code)
    for seed, (cc, n) in enumerate(((b"BC4U", 4), (b"ATI1", 4), (b"ATI2", 5),
                                    (b"BC5U", 5), (b"BC5S", 5))):
        out[f"dds_fourcc_{cc.decode().lower()}_20x12.dds"] = dds(
            20, 12, FOURCC, random_blocks(300 + seed, 15, n), cc)
    # every BC7 mode and a first byte of 0 in one file, both BC6H kinds
    # over every mode code, and BC6H with endpoints inside [0, 1]
    out["dds_dx10_bc7_modes_36x16.dds"] = dds(
        36, 16, FOURCC, random_blocks(400, 36, 7), b"DX10", dxgi=98)
    zero = bytearray(random_blocks(401, 16, 7))
    for k in range(0, 16, 2):
        zero[16 * k] = 0
    out["dds_dx10_bc7_first_byte0_16x16.dds"] = dds(
        16, 16, FOURCC, bytes(zero), b"DX10", dxgi=98)
    out["dds_dx10_bc6h_uf16_modes_32x16.dds"] = dds(
        32, 16, FOURCC, random_blocks(402, 32, 6), b"DX10", dxgi=95)
    out["dds_dx10_bc6h_sf16_modes_32x16.dds"] = dds(
        32, 16, FOURCC, random_blocks(403, 32, 6), b"DX10", dxgi=96)
    out["dds_dx10_bc6h_uf16_small_16x16.dds"] = dds(
        16, 16, FOURCC, small_bc6h(404, 16), b"DX10", dxgi=95)
    out["dds_dx10_bc6h_sf16_small_16x16.dds"] = dds(
        16, 16, FOURCC, small_bc6h(405, 16), b"DX10", dxgi=96)
    # a BC1 block whose first colour is not above its second: three colours
    # and black
    out["dds_dxt1_three_colours_8x4.dds"] = dds(
        8, 4, FOURCC, bytes.fromhex("1f00e0ff1be46c93") +
        bytes.fromhex("4208420855aaff00"), b"DXT1")


def _dds_raw_cases(out: dict):
    rng = np.random.default_rng(500)
    px = rng.integers(0, 256, 13 * 9 * 5, np.uint8).tobytes()
    masks = {
        "rgb565_16bit": (16, (0xF800, 0x07E0, 0x001F), 0),
        "argb1555_16bit": (16, (0x7C00, 0x03E0, 0x001F, 0x8000), ALPHAPIXELS),
        "argb4444_16bit": (16, (0x0F00, 0x00F0, 0x000F, 0xF000),
                           ALPHAPIXELS),
        "rgb332_8bit": (8, (0xE0, 0x1C, 0x03), 0),
        "rgb888_24bit": (24, (0xFF0000, 0xFF00, 0xFF), 0),
        "bgrx8888_32bit": (32, (0xFF0000, 0xFF00, 0xFF), 0),
        "argb8888_32bit": (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                           ALPHAPIXELS),
        "a2b10g10r10_32bit": (32, (0x3FF, 0xFFC00, 0x3FF00000, 0xC0000000),
                              ALPHAPIXELS),
        "gapped_32bit": (32, (0x00F00F00, 0x0A05, 0x30000003), 0),
        "empty_mask_16bit": (16, (0xF800, 0, 0x001F), 0),
        "bitcount12": (12, (0xF0, 0x0C, 0x03), 0),
        "bitcount0": (0, (0xFF, 0xFF00, 0xFF0000), 0),
        "bitcount40": (40, (0xFF, 0xFF00, 0xFF0000), 0),
    }
    for name, (bits, m, flag) in masks.items():
        body = px[:13 * 9 * max(bits // 8, 1)]
        out[f"dds_{name}_13x9.dds"] = dds(
            13, 9, RGB | flag, body, bitcount=bits, masks=m + (0,) * (
                4 - len(m)))
    out["dds_rgb565_cut_13x9.dds"] = dds(
        13, 9, RGB, px[:100], bitcount=16, masks=(0xF800, 0x07E0, 0x1F, 0))
    out["dds_l8_13x9.dds"] = dds(13, 9, LUMINANCE, px[:117], bitcount=8)
    out["dds_la16_13x9.dds"] = dds(13, 9, LUMINANCE | ALPHAPIXELS,
                                   px[:234], bitcount=16)
    pal = rng.integers(0, 256, 1024, np.uint8).tobytes()
    out["dds_p8_rgba_palette_13x9.dds"] = dds(13, 9, PAL8, pal + px[:117],
                                              bitcount=8)
    out["dds_p8_cut_13x9.dds"] = dds(13, 9, PAL8, pal + px[:100], bitcount=8)
    out["dds_p8_short_palette_13x9.dds"] = dds(13, 9, PAL8, pal[:500],
                                               bitcount=8)
    for name, code in (("typeless", 27), ("unorm", 28), ("srgb", 29)):
        out[f"dds_dx10_r8g8b8a8_{name}_13x9.dds"] = dds(
            13, 9, FOURCC, px[:468], b"DX10", dxgi=code)


def _dds_refusal_cases(out: dict):
    blocks = random_blocks(600, 15, 1)
    out["dds_header_size_100_20x12.dds"] = dds(20, 12, FOURCC, blocks,
                                               b"DXT1", header_size=100)
    out["dds_header_cut_20x12.dds"] = dds(20, 12, FOURCC, b"", b"DXT1")[:90]
    out["dds_fourcc_dxt2_20x12.dds"] = dds(20, 12, FOURCC, blocks, b"DXT2")
    out["dds_dx10_bc1_srgb_20x12.dds"] = dds(20, 12, FOURCC, blocks, b"DX10",
                                             dxgi=72)
    out["dds_dx10_r16g16_20x12.dds"] = dds(20, 12, FOURCC, blocks, b"DX10",
                                           dxgi=35)
    out["dds_pfflags_none_20x12.dds"] = dds(20, 12, 0, blocks)
    out["dds_pfflags_alpha_only_20x12.dds"] = dds(20, 12, 0x2, blocks)
    out["dds_lum_bitcount12_20x12.dds"] = dds(20, 12, LUMINANCE, blocks,
                                              bitcount=12)
    out["dds_lum16_no_alpha_20x12.dds"] = dds(20, 12, LUMINANCE, blocks,
                                              bitcount=16)
    out["dds_dx10_short_20x12.dds"] = dds(20, 12, FOURCC, b"", b"DX10")[:130]
    out["dds_width0_0x12.dds"] = dds(0, 12, FOURCC, blocks, b"DXT1")
    out["dds_bomb_40000x40000.dds"] = dds(40000, 40000, FOURCC, blocks,
                                          b"DXT1")
    out["dds_dxt1_cut_20x12.dds"] = dds(20, 12, FOURCC, blocks[:100],
                                        b"DXT1")
    out["dds_dx10_bc7_cut_20x12.dds"] = dds(
        20, 12, FOURCC, random_blocks(601, 15, 7)[:239], b"DX10", dxgi=98)
    out["dds_dxt5_tail_20x12.dds"] = dds(
        20, 12, FOURCC, random_blocks(602, 15, 3) + bytes(range(40)),
        b"DXT5")
    out["dds_magic_only_1x1.dds"] = b"DDS "


def _blp_cases(out: dict):
    rgb = picture(10, 13, 19)
    from PIL import Image

    p = Image.fromarray(rgb).quantize(200)
    pa = p.copy()
    pal = bytearray(p.getpalette("RGBA"))
    pal[3::4] = bytes((7 * k) & 255 for k in range(len(pal) // 4))
    pa.putpalette(bytes(pal), "RGBA")
    for ver in ("BLP1", "BLP2"):
        out[f"{ver.lower()}_pillow_p_19x13.blp"] = pillow_written(
            p, "BLP", blp_version=ver)
        out[f"{ver.lower()}_pillow_pa_19x13.blp"] = pillow_written(
            pa, "BLP", blp_version=ver)
    # BLP2 DXT at widths that cut a block: the rows skew
    for enc, name in ((0, "dxt1"), (1, "dxt3"), (7, "dxt5")):
        n = {0: 1, 1: 2, 7: 3}[enc]
        for w in (1, 5, 6, 7):
            for alpha in (0, 1):
                h = 6
                nb = ((w + 3) // 4) * ((h + 3) // 4)
                body = random_blocks(700 + 10 * w + enc + alpha, nb, n)
                out[f"blp2_{name}_alpha{alpha}_{w}x{h}.blp"] = blp2(
                    w, h, body, alpha=alpha, alpha_encoding=enc)
    body = random_blocks(750, 6, 1)
    out["blp2_dxt1_cut_8x12.blp"] = blp2(8, 12, body[:40])
    out["blp2_dxt_alpha_encoding3_8x12.blp"] = blp2(8, 12, body,
                                                    alpha_encoding=3)
    out["blp2_raw_bgra_encoding3_8x12.blp"] = blp2(8, 12, body, encoding=3)
    out["blp2_compression0_8x12.blp"] = blp2(8, 12, body, compression=0)
    out["blp2_offset_past_end_8x12.blp"] = blp2(8, 12, body,
                                                offsets=[100000])
    out["blp2_palette_cut_8x12.blp"] = blp2(8, 12, b"")[:600]
    out["blp2_dxt1_in_palette_8x12.blp"] = blp2(8, 12, body, offsets=[148])
    idx = np.random.default_rng(751).integers(0, 256, 8 * 12, np.uint8)
    bgra = np.random.default_rng(752).integers(0, 256, 1024,
                                               np.uint8).tobytes()
    out["blp2_palette_lengths_short_8x12.blp"] = blp2(
        8, 12, idx.tobytes(), encoding=1, palette=bgra, lengths=[90])
    out["blp2_palette_lengths_long_8x12.blp"] = blp2(
        8, 12, idx.tobytes() + bytes(20), encoding=1, palette=bgra)
    # the indices at the first offset, past 16 bytes after the palette
    out["blp2_palette_offset_gap_8x12.blp"] = blp2(
        8, 12, bytes(range(16)) + idx.tobytes(), encoding=1, palette=bgra,
        offsets=[20 + 128 + 1024 + 16], lengths=[96])
    # DXT blocks inside where the palette would be, the file too short
    # for the palette Pillow reads first
    out["blp2_dxt1_short_palette_8x12.blp"] = blp2(8, 12, body,
                                                   offsets=[148],
                                                   palette=b"")
    out["blp1_palette_encoding4_8x12.blp"] = blp1(
        8, 12, bgra + idx.tobytes(), encoding=4, lengths=[96])
    out["blp1_palette_alpha_8x12.blp"] = blp1(
        8, 12, bgra + idx.tobytes(), alpha=8, lengths=[96])
    out["blp1_encoding3_8x12.blp"] = blp1(8, 12, bgra + idx.tobytes(),
                                          encoding=3, lengths=[96])
    out["blp1_compression2_8x12.blp"] = blp1(
        8, 12, bgra + idx.tobytes(), compression=2, lengths=[96])
    out["blp1_palette_cut_8x12.blp"] = blp1(8, 12, bgra[:700], lengths=[96])
    out["blp1_short_header_1x1.blp"] = b"BLP1" + struct.pack("<iI", 1, 0) + \
        struct.pack("<II", 8, 12)[:6]
    out["blp2_short_header_1x1.blp"] = b"BLP2" + bytes(8)
    out["blp1_width0_0x12.blp"] = blp1(0, 12, bgra + idx.tobytes(),
                                       lengths=[96])
    out["blp2_bomb_40000x40000.blp"] = blp2(40000, 40000, body)


def _jpeg(rgb: np.ndarray, mode: str) -> bytes:
    return pillow_written(rgb, "JPEG", mode, quality=90)


def _blp1_jpeg(w: int, h: int, jpeg: bytes, split: int, alpha: int = 0,
               gap: int = 0, length: int = None) -> bytes:
    """A BLP1 JPEG: the JPEG's first split bytes as the shared header,
    gap bytes, then the rest as the first mipmap (offsets[0] where it
    lies; a negative gap points that far before the header's end)."""
    head, rest = jpeg[:split], jpeg[split:]
    at = 28 + 128 + 4 + split + gap
    body = struct.pack("<I", split) + head + bytes(max(gap, 0)) + rest
    return blp1(w, h, body, compression=0, alpha=alpha, offsets=[at],
                lengths=[len(rest) if length is None else length])


def _blp_jpeg_cases(out: dict):
    rgb = picture(20, 12, 17)
    ycc = _jpeg(rgb, "RGB")
    out["blp1_jpeg_ycbcr_17x12.blp"] = _blp1_jpeg(17, 12, ycc, 150)
    out["blp1_jpeg_alpha_17x12.blp"] = _blp1_jpeg(17, 12, ycc, 150, alpha=1)
    out["blp1_jpeg_grey_17x12.blp"] = _blp1_jpeg(17, 12, _jpeg(rgb, "L"), 90)
    out["blp1_jpeg_cmyk_17x12.blp"] = _blp1_jpeg(17, 12, _jpeg(rgb, "CMYK"),
                                                 200)
    with open(os.path.join(os.path.dirname(FOLDER), "torch_pillow_corpus",
                           "ycck_444_37x53.jpg"), "rb") as f:
        ycck = f.read()
    out["blp1_jpeg_ycck_37x53.blp"] = _blp1_jpeg(37, 53, ycck, 300)
    out["blp1_jpeg_skip_17x12.blp"] = _blp1_jpeg(17, 12, ycc, 150, gap=33)
    out["blp1_jpeg_skip_back_17x12.blp"] = _blp1_jpeg(17, 12, ycc, 150,
                                                      gap=-60)
    out["blp1_jpeg_wider_than_blp_13x12.blp"] = _blp1_jpeg(13, 12, ycc, 150)
    out["blp1_jpeg_narrower_than_blp_20x12.blp"] = _blp1_jpeg(20, 12, ycc,
                                                              150)
    out["blp1_jpeg_cut_17x12.blp"] = _blp1_jpeg(17, 12, ycc[:-200], 150)
    out["blp1_jpeg_length_short_17x12.blp"] = _blp1_jpeg(
        17, 12, ycc, 150, length=len(ycc) - 400)
    out["blp1_jpeg_not_a_jpeg_17x12.blp"] = _blp1_jpeg(17, 12, bytes(
        range(256)) * 2, 100)
    out["blp1_jpeg_header_past_end_17x12.blp"] = blp1(
        17, 12, struct.pack("<I", 5000) + ycc[:100], compression=0)


def _ftex_cases(out: dict):
    blocks = random_blocks(800, 20, 1)
    rgb = picture(30, 13, 19).tobytes()
    out["ftex_dxt1_19x13.ftc"] = ftex(19, 13, 0, blocks)
    out["ftex_rgb_19x13.ftu"] = ftex(19, 13, 1, rgb)
    out["ftex_rgb_long_mipmap_19x13.ftu"] = ftex(19, 13, 1, rgb + bytes(50))
    out["ftex_format2_19x13.ftc"] = ftex(19, 13, 2, blocks)
    out["ftex_format_count2_19x13.ftc"] = ftex(19, 13, 0, blocks,
                                               format_count=2)
    out["ftex_where_negative_19x13.ftc"] = ftex(19, 13, 0, blocks, where=-4)
    out["ftex_where_past_end_19x13.ftc"] = ftex(19, 13, 0, blocks,
                                                where=100000)
    out["ftex_mipmap_size_negative_19x13.ftc"] = ftex(19, 13, 0, blocks,
                                                      mipmap_size=-1)
    out["ftex_mipmap_size_short_19x13.ftc"] = ftex(19, 13, 0, blocks,
                                                   mipmap_size=100)
    # read to the end from a stream, refused by path (a file's read of a
    # negative size other than -1 fails)
    out["ftex_mipmap_size_minus5_19x13.ftc"] = ftex(19, 13, 0, blocks,
                                                    mipmap_size=-5)
    out["ftex_mipmap_cut_19x13.ftc"] = ftex(19, 13, 0, blocks[:120])
    out["ftex_where_in_header_4x4.ftc"] = ftex(4, 4, 0, blocks, where=8)
    out["ftex_size_negative_19x13.ftc"] = ftex(-19, 13, 0, blocks)
    out["ftex_short_header_1x1.ftc"] = b"FTEX" + bytes(10)
    # FTEX passes it on (its mipmap lies past the end): SPIDER reads it,
    # its first float "FTEX" little-endian, an integer; FTEX's size (SPIDER
    # header words 3 and 4) above 0
    spider = _sibling("torch_raster_corpus").spider(
        np.random.default_rng(801).random((5, 6), np.float32) * 200,
        big=False, patch={3: 1.0, 4: 1.0})
    buf = bytearray(spider)
    buf[:4] = b"FTEX"
    buf[20:24] = struct.pack("<i", 1)
    buf[28:32] = struct.pack("<i", 1 << 30)
    out["ftex_spider_6x5.spi"] = bytes(buf)


def cases() -> dict:
    """{file name: bytes}."""
    out = {}
    _dds_pillow_cases(out)
    _dds_block_cases(out)
    _dds_raw_cases(out)
    _dds_refusal_cases(out)
    _blp_cases(out)
    _blp_jpeg_cases(out)
    _ftex_cases(out)
    return out


# -- the scenes, made at run time ---------------------------------------------

def scene_cases(rgb: np.ndarray) -> dict:
    """The 640x480 scene in the seven forms chip_smoke.py's 9t reads:
    numpy alone."""
    h, w = rgb.shape[:2]
    dxt1 = dxt1_blocks(rgb).tobytes()
    idx, pal = palette_image(rgb)
    return {
        "scene_dds_dxt1_640x480.dds": dds(w, h, FOURCC, dxt1, b"DXT1"),
        "scene_dds_bc7_640x480.dds": dds(
            w, h, FOURCC, bc7_mode6_blocks(rgb).tobytes(), b"DX10",
            dxgi=98),
        "scene_dds_bc6h_640x480.dds": dds(
            w, h, FOURCC, bc6h_mode11_blocks(rgb).tobytes(), b"DX10",
            dxgi=95),
        "scene_dds_rgb565_640x480.dds": dds(
            w, h, RGB, rgb565_pixels(rgb), bitcount=16,
            masks=(0xF800, 0x07E0, 0x001F, 0)),
        "scene_blp2_dxt5_640x480.blp": blp2(
            w, h, dxt5_blocks(rgb).tobytes(), alpha=8, alpha_encoding=7),
        "scene_blp1_palette_640x480.blp": blp1(
            w, h, pal + idx.tobytes(), lengths=[w * h]),
        "scene_ftex_dxt1_640x480.ftc": ftex(w, h, 0, dxt1),
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
