"""The legacy-zstd TIFF corpus (tests/fixtures/torch_tiff_zstd_legacy_corpus/):
ZSTD TIFF (Compression 50000) whose strips or tiles are zstd frames of the
v0.5, v0.6 and v0.7 formats. The JAX package hands them to Pillow 12.1.0,
whose libtiff 4.7.1 reads them with ZSTDDecode over libzstd 1.5.7, which
passes a chunk with a legacy magic to that version's streaming decoder;
the port reads them in data/tiff.py and csrc/zstd_decode.cc.

Every frame is written by tests/torch_zstd_legacy.py (no library here
writes these formats). The files, small ones made from numpy seeds:

- the three frames of one raw block each (v0.5 magic and one descriptor
  byte, v0.6 the same, v0.7 descriptor 0 and window byte 0) as the only
  strip of a 16x4 grey image;
- per version, frame headers (window logs, reserved bits, v0.6 and v0.7
  content sizes, v0.7's single segment, dictionary ID and checksum), raw,
  RLE (which the streaming decoders refuse), compressed and empty blocks,
  each literals mode and each sequence-table mode, repeat offsets (within
  a block and, in v0.7 only, from one block to the next), long
  literal and match lengths, frames that end early, run past the strip or
  stop short, one block decoded past a full output, a v0.5 buffer that
  restarts at every block, the stream's legacy context carried from one
  strip to the next, and versions mixed with a v1 frame in one image;
- in strips and tiles, contiguous and planar, with predictor 2, in both
  byte orders, in BigTIFF and under Orientation 1-8;
- the 640x480 scene (tests/torch_jpeg_fixtures.py:scene 0) for
  chip_smoke.py's phase 9p in v0.5 and v0.7 frames of compressed blocks
  (also under Orientation 6): the card has no encoder the port may rely
  on, so these are committed.

``digests.json`` holds each JAX route's pixels' sha256 and Pillow's size
(tests/torch_tiff_corpus.py:reference). ``cases()`` also names the files
whose frames libzstd decodes to their payload both ways (ZSTD_decompress
and ZSTD_decompressStream), with those frames. Remake with (Pillow and the
JAX package)

  python -m tests.torch_tiff_zstd_legacy_corpus [folder]
"""

import json
import os
import struct
import sys

import numpy as np


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


tc = _sibling("torch_tiff_corpus")
tj = _sibling("torch_tiff_jpeg_corpus")
zl = _sibling("torch_zstd_legacy")

FOLDER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                      "torch_tiff_zstd_legacy_corpus")
DIGESTS = "digests.json"
# the scenes chip_smoke.py's phase 9p reads (their PPM twins are made there)
SCENES = ("scene_z5_640x480.tif", "scene_z7_640x480.tif")
# detect --img's file there: the v0.7 scene under Orientation 6
ROTATED = "scene_z7_orient6_640x480.tif"


def picture(seed: int, h: int, w: int, channels: int = 3) -> np.ndarray:
    """Smooth colour with some noise: compressible, with matches."""
    return tc.picture(seed, h, w, channels).astype(np.uint8)


def _split(samples: np.ndarray, rows_per_strip: int, planar: bool,
           tile: int, predictor: int) -> tuple:
    """The chunks' raw bytes as libtiff lays them out, and the tags of
    their layout."""
    h, w, spp = samples.shape
    planes = [samples] if not planar else \
        [samples[..., i:i + 1] for i in range(spp)]
    chunks = []
    for p in planes:
        n = p.shape[2]
        if tile:
            for y in range(0, h, tile):
                for x in range(0, w, tile):
                    t = np.zeros((tile, tile, n), np.uint8)
                    part = p[y:y + tile, x:x + tile]
                    t[:part.shape[0], :part.shape[1]] = part
                    rows = t.reshape(tile, tile * n)
                    if predictor == 2:
                        rows = tc.horizontal(rows, n)
                    chunks.append(rows.tobytes())
        else:
            for y in range(0, h, rows_per_strip):
                rows = np.ascontiguousarray(p[y:y + rows_per_strip]).reshape(
                    -1, w * n)
                if predictor == 2:
                    rows = tc.horizontal(rows, n)
                chunks.append(rows.tobytes())
    if tile:
        layout = {322: tile, 323: tile, 324: tc.CHUNKS, 325: tc.CHUNKS}
    else:
        layout = {273: tc.CHUNKS, 278: rows_per_strip, 279: tc.CHUNKS}
    return chunks, layout


def legacy_tiff(samples: np.ndarray, encode, *, rows_per_strip: int = 0,
                planar: bool = False, tile: int = 0, predictor: int = 1,
                photometric: int = None, endian: str = "<",
                big: bool = False, more=None, record=None) -> bytes:
    """A ZSTD TIFF of (h, w, spp) uint8 samples: chunk k of raw bytes b is
    encode(k, b). record: a list that gets (chunk, b) of each chunk."""
    samples = np.ascontiguousarray(samples, np.uint8)
    h, w, spp = samples.shape
    raw, layout = _split(samples, rows_per_strip or h, planar, tile,
                         predictor)
    chunks = [encode(k, b) for k, b in enumerate(raw)]
    if record is not None:
        record.extend(zip(chunks, raw))
    if photometric is None:
        photometric = 1 if spp == 1 else 2
    tags = {256: w, 257: h, 258: (8,) * spp if spp > 1 else 8,
            259: 50000, 262: photometric, 277: spp}
    tags.update(layout)
    if planar:
        tags[284] = 2
    if predictor != 1:
        tags[317] = predictor
    tags.update(more or {})
    return tc.tiff_file(tags, chunks, endian=endian, big=big)


def framer(version: int, **kw):
    """encode(k, bytes) making one frame of a version of each chunk."""
    return lambda k, b: zl.frame(version, b, **kw)


def _raw_frame(version: int, payload: bytes) -> bytes:
    """The smallest frame of one raw block: magic, the descriptor byte(s)
    at 0, the block, the end block."""
    head = struct.pack("<I", zl.MAGIC[version]) + \
        (b"\x00\x00" if version == 7 else b"\x00")
    return head + zl.raw_block(payload) + zl.end_block(version)


class Cases(dict):
    """The corpus being made: name -> bytes, and in frames, for the files
    whose every chunk is a frame libzstd decodes to its payload both by
    ZSTD_decompress and by ZSTD_decompressStream, name -> [(chunk,
    payload)]."""

    def __init__(self):
        super().__init__()
        self.frames = {}

    def add(self, name: str, samples, encode, valid: bool = False, **kw):
        record = [] if valid else None
        self[name] = legacy_tiff(samples, encode, record=record, **kw)
        if valid:
            self.frames[name] = record

    def strip(self, name: str, samples, chunk: bytes, valid: bool = False):
        self.add(name, samples, lambda k, b: chunk, valid)


P10 = np.array([.4, .2, .1, .1, .05, .05, .04, .03, .02, .01])


def _frames_cases(out: Cases):
    """Whole frames of each version, in each layout."""
    grey = (np.arange(64, dtype=np.uint8).reshape(4, 16, 1) * 3 + 7)
    for v in (5, 6, 7):
        out.add(f"z{v}_raw_16x4.tif", grey,
                lambda k, b, v=v: _raw_frame(v, b), True)
    pic = picture(1, 29, 37)
    skew = np.random.default_rng(2).choice(
        np.arange(12), (29, 37, 3), p=np.array(
            [30, 20, 10, 9, 8, 7, 5, 4, 3, 2, 1, 1]) / 100).astype(np.uint8)
    for v in (5, 6, 7):
        p = f"z{v}"
        wl = 18 if v == 5 else 17
        for name, kw in (
                ("lz", {}), ("lz_blocks", {"block_size": 700}),
                ("raw_lz_blocks", {"block_size": 500,
                                   "kinds": ("raw", "lz")}),
                ("lits_raw", {"lits": "raw"}),
                ("lits_huf1", {"lits": "huf1", "block_size": 900}),
                ("lits_huf4", {"lits": "huf4"}),
                ("weights_raw", {"lits": "huf4", "weights": "raw"}),
                ("tables_predef", {"modes": (("raw" if v == 5
                                              else "predef"),) * 3}),
                ("tables_fse", {"modes": ("fse",) * 3}),
                ("tables_fse_low", {"modes": ("fse",) * 3, "low": True}),
                ("no_repeat", {"use_rep": False})):
            src = skew if "weights" in name or "huf" in name else pic
            out.add(f"{p}_{name}_37x29.tif", src,
                    framer(v, window_log=wl, **kw), True)
        enc = framer(v, window_log=wl)
        out.add(f"{p}_strips_pred2_37x29.tif", pic, enc, True,
                rows_per_strip=8, predictor=2)
        out.add(f"{p}_tiles_37x29.tif", pic, enc, True, tile=16)
        out.add(f"{p}_planar_37x29.tif", pic, enc, True, planar=True,
                rows_per_strip=16)
        out.add(f"{p}_be_grey_37x29.tif", pic[..., :1], enc, True,
                endian=">", rows_per_strip=10)
    out.add("z7_bigtiff_37x29.tif", pic, framer(7, checksum=True), True,
            big=True, rows_per_strip=16)
    for o in range(1, 9):
        v = 5 + o % 3
        out.add(f"z{v}_orient{o}_37x29.tif", pic, framer(v, window_log=18),
                True, more={274: o}, rows_per_strip=16)


def _header_cases(out: Cases):
    """Frame headers: what each version reads, and refuses."""
    g = picture(3, 13, 19)
    raw = g.tobytes()
    n = len(raw)
    blk = zl.raw_block(raw) + zl.end_block(5)
    # v0.5: window log 11 to 26; the upper nibble reserved
    for wl in (11, 26):
        out.strip(f"z5_window_log{wl}_19x13.tif", g,
                  zl.frame_header(5, wl) + blk, True)
    out.strip("z5_reserved_bit4_19x13.tif", g,
              zl.frame_header(5, 17, reserved=0x10) + blk)
    # v0.6: content size fields (never checked), bit 5 reserved, bit 4 not
    for code, cs in ((1, 7), (2, n), (3, 5)):
        out.strip(f"z6_fcs_code{code}_19x13.tif", g,
                  zl.frame_header(6, 17, cs, fcs_code=code) + blk, cs == n)
    out.strip("z6_reserved_bit5_19x13.tif", g,
              zl.frame_header(6, 17, reserved=0x20) + blk)
    out.strip("z6_bit4_19x13.tif", g,
              zl.frame_header(6, 17, reserved=0x10) + blk, True)
    out.strip("z6_window_log27_19x13.tif", g, zl.frame_header(6, 27) + blk,
              True)
    # v0.7: single segment and its content size, the window's mantissa,
    # dictionary ID, reserved bit 3 (bit 4 unused), window log past 27,
    # a content size that is wrong (never checked), the checksum
    out.strip("z7_single_fcs2_19x13.tif", g,
              zl.frame_header(7, 17, n, single=True, fcs_code=2) + blk, True)
    out.add("z7_single_small_16x4.tif", g[:4, :16, :1],
            lambda k, b: zl.frame_header(7, 17, len(b), single=True) +
            zl.raw_block(b) + zl.end_block(7), True)
    out.strip("z7_window_mantissa_19x13.tif", g,
              zl.frame_header(7, 10, window_mantissa=7) + blk, True)
    out.strip("z7_dict_id_19x13.tif", g,
              zl.frame_header(7, 17, dict_id=1234) + blk)
    out.strip("z7_reserved_bit3_19x13.tif", g,
              zl.frame_header(7, 17, reserved=0x08) + blk)
    out.strip("z7_bit4_19x13.tif", g,
              zl.frame_header(7, 17, reserved=0x10) + blk, True)
    out.strip("z7_window_log28_19x13.tif", g, zl.frame_header(7, 28) + blk)
    out.strip("z7_wrong_content_size_19x13.tif", g,
              zl.frame_header(7, 17, 5, fcs_code=2) + blk)
    good = zl.frame(7, raw, checksum=True)
    out.strip("z7_checksum_19x13.tif", g, good, True)
    bad = bytearray(good)
    bad[-1] ^= 1
    out.strip("z7_bad_checksum_19x13.tif", g, bytes(bad))
    # the checksum is read only at the end block, which a frame longer
    # than the strip never reaches
    longer = bytearray(zl.frame(7, raw + raw, checksum=True,
                                block_size=len(raw)))
    longer[-1] ^= 1
    out.strip("z7_longer_bad_checksum_19x13.tif", g, bytes(longer))
    # the magic alone, the descriptor without its window byte, v0.4
    out.strip("z7_magic_only_19x13.tif", g, zl.frame_header(7)[:4])
    out.strip("z7_header_cut_19x13.tif", g, zl.frame_header(7)[:5])
    out.strip("z4_magic_19x13.tif", g,
              struct.pack("<I", 0xFD2FB524) + b"\x00" + blk)


def _block_cases(out: Cases):
    """Blocks and the streaming decoders' loop."""
    g = picture(4, 13, 19)
    raw = g.tobytes()
    half = len(raw) // 2
    flat = np.full((13, 19, 3), 77, np.uint8)
    big = picture(5, 64, 48)
    for v in (5, 6, 7):
        p = f"z{v}"
        wl = 18 if v == 5 else 17
        head = zl.frame_header(v, wl)
        end = zl.end_block(v)
        # RLE blocks: "not yet handled" by the streaming decoders
        out.strip(f"{p}_rle_block_19x13.tif", flat,
                  head + zl.rle_block(77, len(raw)) + end)
        # a block of size 0 ends the streaming decoder's frame
        out.strip(f"{p}_empty_block_first_19x13.tif", g,
                  head + zl.raw_block(b"") + zl.raw_block(raw) + end)
        out.strip(f"{p}_empty_block_mid_19x13.tif", g,
                  head + zl.raw_block(raw[:half]) + zl.raw_block(b"") +
                  zl.raw_block(raw[half:]) + end)
        out.strip(f"{p}_no_end_block_19x13.tif", g,
                  head + zl.raw_block(raw))
        out.strip(f"{p}_short_frame_19x13.tif", g,
                  head + zl.raw_block(raw[:half]) + end)
        out.strip(f"{p}_cut_mid_block_19x13.tif", g,
                  head + zl.raw_block(raw)[:half])
        # one block decoded past a full output: a bad one refuses the
        # chunk, a cut one does not
        enc = zl.Encoder(v, 1 << (wl - (v == 5)))
        good = enc.block(raw + raw, len(raw), 2 * len(raw))
        bad_block = bytearray(good)
        bad_block[-1] = 0
        out.strip(f"{p}_bad_block_after_full_19x13.tif", g,
                  head + zl.raw_block(raw) + bytes(bad_block) + end)
        out.strip(f"{p}_cut_block_after_full_19x13.tif", g,
                  head + zl.raw_block(raw) + good[:len(good) // 2])
        out.strip(f"{p}_longer_than_strip_19x13.tif", g,
                  zl.frame(v, raw + raw[::-1], window_log=wl))
        # bytes after the frame's end are never read
        out.strip(f"{p}_bytes_after_end_19x13.tif", g,
                  zl.frame(v, raw, window_log=wl) + b"\x28\xb5\x2f\xfd..")
        # a raw block larger than the smallest window's buffer
        out.strip(f"{p}_raw_block_past_window_48x64.tif", big,
                  zl.frame_header(v, {5: 11, 6: 12, 7: 10}[v]) +
                  zl.raw_block(big.tobytes()) + end)
    # v0.5's buffer is the window alone: at 2^17 it restarts at every
    # block, and a match into the block before reads what the new block
    # wrote over it
    pic = picture(6, 40, 64)
    out.add("z5_buffer_restart_64x40.tif", pic,
            framer(5, window_log=17, block_size=1500))
    out.add("z5_buffer_restart_raw_64x40.tif", pic,
            framer(5, window_log=17, block_size=1500, kinds=("raw",)), True)


def _lit_block(section: bytes) -> bytes:
    """A compressed block of a literals section and no sequences."""
    return zl.block_header(0, len(section) + 1) + section + b"\x00"


def _image(data: bytes, w: int) -> np.ndarray:
    px = np.frombuffer(data, np.uint8)
    return px.reshape(len(px) // w, w, 1)


def _literal_mode_cases(out: Cases, v: int, rng):
    p = f"z{v}"
    head = zl.frame_header(v, 18)
    end = zl.end_block(v)
    # RLE and raw literals at each header size
    for n, w in ((20, 20), (3000, 100), (70000, 1000)):
        px = bytes([9]) * n
        out.strip(f"{p}_lits_rle_{w}x{n // w}.tif", _image(px, w),
                  head + _lit_block(zl.literals_rle(px)) + end, True)
        px = rng.integers(0, 256, n, np.uint8).tobytes()
        out.strip(f"{p}_lits_rawhdr_{w}x{n // w}.tif", _image(px, w),
                  head + _lit_block(zl.literals_raw(px)) + end, True)
    # four Huffman streams: one symbol a lookup (the table HUF picks for
    # few literals) and two (for many)
    for n, w, kind in ((2000, 40, "x2"), (24000, 200, "x4")):
        lits = rng.choice(np.arange(10), n, p=P10).astype(np.uint8)
        sec, _ = zl.literals_huffman(lits.tobytes(), version=v)
        out.strip(f"{p}_huf4_{kind}_{w}x{n // w}.tif",
                  _image(lits.tobytes(), w), head + _lit_block(sec) + end,
                  True)
    # the weights' RLE header (every weight 1)
    lits = rng.integers(0, 2, 200).astype(np.uint8).tobytes()
    t = zl.Huffman(lits)
    body = t.stream(lits)
    sec = zl._huf_header(0, 1, len(lits), len(body) + 1) + bytes([242]) + \
        body
    out.strip(f"{p}_weights_rle_20x10.tif", _image(lits, 20),
              head + _lit_block(sec) + end, True)
    # a four-stream section of one byte (v0.5, v0.6: every literal that
    # byte) and one as long as its literals (v0.6: copied)
    out.strip(f"{p}_huf4_one_byte_20x3.tif", _image(b"\x41" * 60, 20),
              head + _lit_block(zl._huf_header(0, 0, 60, 1) + b"\x41") +
              end)
    same = bytes(range(60))
    out.strip(f"{p}_huf4_uncompressed_20x3.tif", _image(same, 20),
              head + _lit_block(zl._huf_header(0, 0, 60, 60) + same) + end)
    # the last Huffman table again (v0.7, after a two-symbol table only)
    l1 = rng.choice(np.arange(10), 24000, p=P10).astype(np.uint8).tobytes()
    l0 = rng.choice(np.arange(10), 1400, p=P10).astype(np.uint8).tobytes()
    l2 = rng.choice(np.arange(10), 600, p=P10).astype(np.uint8).tobytes()
    for first, kind in ((l1, "x4"), (l0, "x2")):
        s1, t = zl.literals_huffman(first, version=v)
        s2, _ = zl.literals_huffman(l2, True, t)
        out.strip(f"{p}_lits_repeat_{kind}_100x{(len(first) + 600) // 100}"
                  ".tif", _image(first + l2, 100),
                  head + _lit_block(s1) + _lit_block(s2) + end,
                  v == 7 and kind == "x4")


def _sequence_mode_cases(out: Cases, v: int, rng):
    p = f"z{v}"
    head = zl.frame_header(v, 18)
    end = zl.end_block(v)
    predef = ("raw" if v == 5 else "predef",) * 3
    # FSE tables, then the last block's tables twice (v0.7 only)
    data, blocks, prev = bytearray(), [], None
    rep = zl.Rep(v)
    seqs = [(5, int(o), int(m)) for o, m in
            zip(rng.integers(1, 6, 20), rng.integers(4, 30, 20))]
    for b in range(3):
        lits = bytearray()
        for ll, off, ml in seqs:
            chunk = rng.integers(0, 256, ll).astype(np.uint8).tobytes()
            lits += chunk
            data += chunk
            for _ in range(ml):
                data.append(data[-off])
        rep = rep if v == 7 else zl.Rep(v)
        modes = ("fse",) * 3 if b == 0 else ("repeat",) * 3
        body, prev = zl.sequences_section(
            v, [(a, o, m, False) for a, o, m in seqs], rep, modes, prev)
        section = zl.literals_raw(bytes(lits)) + body
        blocks.append(zl.block_header(0, len(section)) + section)
    out.strip(f"{p}_tables_repeat_{len(data)}x1.tif", _image(bytes(data),
                                                              len(data)),
              head + b"".join(blocks) + end, v == 7)
    # RLE tables: every sequence of the same codes
    data, lits, seq = bytearray(), bytearray(), []
    for _ in range(40):
        chunk = rng.integers(0, 256, 3).astype(np.uint8).tobytes()
        lits += chunk
        data += chunk
        for _ in range(6):
            data.append(data[-3])
        seq.append((3, 3, 6, False))
    body, _ = zl.sequences_section(v, seq, zl.Rep(v), ("rle",) * 3)
    section = zl.literals_raw(bytes(lits)) + body
    out.strip(f"{p}_tables_rle_{len(data) // 4}x4.tif",
              _image(bytes(data), len(data) // 4),
              head + zl.block_header(0, len(section)) + section + end, True)
    # long literal and match lengths (v0.5's dumps, the wide codes)
    data = bytearray(rng.integers(0, 256, 700).astype(np.uint8).tobytes())
    for _ in range(40000):
        data.append(data[-3])
    data += rng.integers(0, 256, 300).astype(np.uint8).tobytes()
    for _ in range(69000):
        data.append(data[-5])
    lits = bytes(data[:700]) + bytes(data[40700:41000])
    body, _ = zl.sequences_section(
        v, [(700, 3, 40000, False), (300, 5, 69000, False)], zl.Rep(v),
        predef)
    section = zl.literals_raw(lits) + body
    out.strip(f"{p}_long_lengths_1000x{len(data) // 1000}.tif",
              _image(bytes(data), 1000),
              head + zl.block_header(0, len(section)) + section + end, True)
    # many sequences (nbSeq's two-byte form) with repeat offsets
    pic = picture(9, 60, 90)
    out.add(f"{p}_many_sequences_90x60.tif", pic,
            framer(v, window_log=18, modes=("fse",) * 3), True)


def _repeat_offset_cases(out: Cases):
    """Repeat offsets across blocks: v0.7 carries them, v0.6 starts each
    block at 1, 1, 1."""
    rng = np.random.default_rng(10)
    plans = ([(20, 17, 6), (3, 9, 5), (5, 5, 7)],
             [(2, 9, 6), (3, 5, 5), (2, 1, 8)])
    for v, name in ((6, "z6_repeats_reset_per_block"),
                    (7, "z7_repeats_across_blocks")):
        data, blocks, rep = bytearray(), [], zl.Rep(v)
        for plan in plans:
            lits, seqs = bytearray(), []
            for ll, off, ml in plan:
                chunk = rng.integers(0, 256, ll).astype(np.uint8).tobytes()
                lits += chunk
                data += chunk
                for _ in range(ml):
                    data.append(data[-off])
                seqs.append((ll, off, ml, True))
            rep = rep if v == 7 else zl.Rep(v)
            body, _ = zl.sequences_section(v, seqs, rep, ("predef",) * 3)
            section = zl.literals_raw(bytes(lits)) + body
            blocks.append(zl.block_header(0, len(section)) + section)
        out.strip(f"{name}_{len(data)}x1.tif", _image(bytes(data), len(data)),
                  zl.frame_header(v, 18) + b"".join(blocks) +
                  zl.end_block(v), True)


def _mode_cases(out: Cases):
    """Literals and sequence sections by hand: each mode, as each version
    takes or refuses it."""
    rng = np.random.default_rng(7)
    for v in (5, 6, 7):
        _literal_mode_cases(out, v, rng)
        _sequence_mode_cases(out, v, rng)


def _stream_cases(out: Cases):
    """The stream's legacy context from strip to strip, and versions mixed
    in one image."""
    pic = picture(8, 40, 64)
    small = (lambda b: zl.frame_header(7, 10) + zl.raw_block(b) +
             zl.end_block(7))
    # strip 1 a v0.7 frame of a large window; strip 2 one of the smallest
    # window, whose block is larger than that window's buffer: decoded in
    # the buffer strip 1 left
    out.add("z7_context_carried_64x40.tif", pic,
            lambda k, b: zl.frame(7, b, window_log=20) if k == 0
            else small(b), rows_per_strip=20)
    out.add("z7_small_window_big_block_64x40.tif", pic,
            lambda k, b: small(b), rows_per_strip=20)
    # another version first: a fresh context for v0.7
    out.add("z5_then_z7_small_window_64x40.tif", pic,
            lambda k, b: zl.frame(5, b, window_log=20) if k == 0
            else small(b), rows_per_strip=20)
    zc = _sibling("torch_tiff_zstd_lzma_corpus")
    out.add("zmixed_versions_64x40.tif", pic,
            lambda k, b: (zl.frame(5, b, window_log=18),
                          zc.zstd_frame(b, level=3), zl.frame(6, b),
                          zl.frame(7, b, checksum=True))[k % 4],
            rows_per_strip=10)


def scene_cases(rgb: np.ndarray, out: Cases = None) -> Cases:
    """The 640x480 scene for phase 9p: v0.5 and v0.7 frames of compressed
    blocks, strips of 16 rows."""
    out = Cases() if out is None else out
    rgb = np.ascontiguousarray(rgb, np.uint8)
    out.add(SCENES[0], rgb, framer(5, window_log=19), True,
            rows_per_strip=16)
    z7 = framer(7, window_log=17, checksum=True)
    out.add(SCENES[1], rgb, z7, True, rows_per_strip=16)
    out.add(ROTATED, rgb, z7, True, rows_per_strip=16, more={274: 6})
    return out


def cases() -> Cases:
    torch_jpeg_fixtures = _sibling("torch_jpeg_fixtures")
    out = Cases()
    _frames_cases(out)
    _header_cases(out)
    _block_cases(out)
    _mode_cases(out)
    _repeat_offset_cases(out)
    _stream_cases(out)
    scene_cases(torch_jpeg_fixtures.scene(0), out)
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
