"""The CCITT fax, ThunderScan and SGILog TIFF corpus
(tests/fixtures/torch_tiff_fax_corpus/): files the JAX package hands to
Pillow 12.1.0, whose TiffImagePlugin reads them over libtiff 4.7.1
(tif_fax3.c's decoders for Compression 2, 3, 4 and 32771; tif_thunder.c
for 32809; tif_luv.c refuses 34676 and 34677 under every photometric
interpretation Pillow opens), and which the port reads in data/tiff.py,
csrc/fax_decode.cc and csrc/tiff_decode.cc.

Small files made from numpy seeds:

- ``fx_lw_*``: tests/torch_tiff_writer.c over Pillow's libtiff: RLE,
  RLEW, Group 3 1D and 2D (T4Options 1), with and without EOL fill bits
  (T4Options 4), Group 4, under both photometric interpretations and both
  fill orders, in strips whose RowsPerStrip does not divide the height,
  in tiles; a palette, Orientation 6, big-endian, BigTIFF; rows wider
  than 1728 and 2560 pixels (the extended make-up codes); widths 1 and 9;
  RLEW as libtiff writes it (its rows aligned from the buffer's start,
  which libtiff's reader, aligning on the address, misreads alike);
- ``fx_hm_*``: streams written here (tests/torch_fax_codecs.py) where
  libtiff's writer never goes: Group 3 with no EOL before the first row,
  with none at all, without one in a later row (libtiff's decoder then
  starts over from the strip's first bit without EOLs, for every later
  strip too), with RTC, with EOL tag bits in 2D every other row; the
  uncompressed-mode extension in 2D rows; bad code words; rows too long
  and too short; strips cut (refused, but Group 4 past its first row);
  Group 4 with and without EOFB, ended early in a later strip (its rows
  then the previous strip's); RLEW with strips at odd and even offsets
  under both fill orders; T4Options of other types, counts and
  duplicates, on other codecs; the Predictor tag on a fax codec; fax
  codecs over 8-bit samples (refused at setup);
- ``sg_*``: SGILog (34676) and SGILog24 (34677) under photometric 0, 1
  and 2 (Pillow opens them; libtiff refuses them at load), and under LogL
  (32844) and LogLuv (32845), which Pillow's open refuses;
- ``th_*``: ThunderScan, which libtiff cannot write, encoded here
  (tests/torch_fax_codecs.py) and written with the writer's raw strips:
  every code (runs, 2-bit and 3-bit deltas with their skip codes, raw
  pixels), deltas that wrap, a run that ends its row, odd widths, both
  photometric interpretations and fill orders, strips whose codes run on
  from row to row; rows short of or past their pixels, 8-bit samples and
  tiles (refused);
- the 640x480 scene (tests/torch_jpeg_fixtures.py:scene 0, its luminance
  thresholded at 40) for chip_smoke.py's phase 9q: as Group 4 (also under
  Orientation 6), Group 3 2D with fill bits under FillOrder 2 and RLE;
  and as 4-bit ThunderScan (the objects at 15 over the background's top
  four bits; also under Orientation 6). All committed.

A Group 4 strip that ends before its rows are all decoded, and a fax tile
whose decode fails (libtiff's tile read takes it for success), leave the
rest of the buffer as it was: Pillow's is uninitialised memory in the
first chunk, so no such first chunk is in the corpus (later chunks show
the previous chunk's rows, which the corpus pins).

``digests.json`` holds, for each file, each JAX route's pixels' sha256
(tests/torch_tiff_corpus.py:reference; null where the route fails) and
the size Pillow reads. Remake the corpus (Pillow, the JAX package, g++
with the system's tiffio.h for the writer) with

  python -m tests.torch_tiff_fax_corpus [folder]

File names give the width before the height.
"""

import json
import os
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
fc = _sibling("torch_fax_codecs")

FOLDER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                      "torch_tiff_fax_corpus")
DIGESTS = "digests.json"
# chip_smoke.py's phases 9q.fax and 9q.thunder: the scenes each reads
# (their PPM twins are made there), the rate scene under Orientation 6
# for detect --img, and the corpus files each checks (by name prefix)
SCENES = ("scene_g4_640x480.tif", "scene_g3_2d_fill_fo2_640x480.tif",
          "scene_rle_640x480.tif")
ROTATED = "scene_g4_orient6_640x480.tif"
THUNDER_SCENES = ("scene_thunder_640x480.tif",)
THUNDER_ROTATED = "scene_thunder_orient6_640x480.tif"
PHASES = {
    "fax": (SCENES, ROTATED, ("fx_", "sg_", "scene_g", "scene_rle")),
    "thunder": (THUNDER_SCENES, THUNDER_ROTATED, ("th_", "scene_thunder")),
}

RLE, G3, G4, RLEW, THUNDER = 2, 3, 4, 32771, 32809
SGILOG, SGILOG24 = 34676, 34677


def bilevel(seed: int, h: int, w: int, density: float = 0.35,
            block: int = 3) -> np.ndarray:
    """(h, w) rows of 0 and 1 (1 black), in blocks as scans have them."""
    rng = np.random.default_rng(seed)
    small = rng.random((h, -(-w // block))) < density
    return np.repeat(small, block, 1)[:, :w].astype(np.uint8)


def nibbles(seed: int, h: int, w: int) -> np.ndarray:
    """(h, w) 4-bit pixels that walk by small steps, with flat stretches."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(-3, 4, (h, w)) * (rng.random((h, w)) < 0.6)
    return (np.cumsum(steps, 1) & 15).astype(np.uint8)


def lw(rows: np.ndarray, compression: int, **spec) -> bytes:
    """rows written by libtiff's own encoder (photometric 0 by default)."""
    spec.setdefault("photometric", 0)
    return tc.libtiff(rows[..., None], bps=1, compression=compression,
                      **spec)


def chunks_of(rows: np.ndarray, compression: int, rps: int,
              **kw) -> list:
    """Each strip of rows as fc.fax_strip writes it (kw to each)."""
    return [fc.fax_strip(rows[y:y + rps], compression, **kw)
            for y in range(0, rows.shape[0], rps)]


def tags_of(w: int, h: int, compression: int, rps: int, *,
            photometric: int = 0, fillorder: int = 1, more=None) -> dict:
    """The tags of a striped bilevel image."""
    tags = tc.tags_for(w, h, 1, 1, photometric, compression, rps,
                       {266: fillorder} if fillorder != 1 else None)
    tags.update(more or {})
    return tags


def fax_file(rows: np.ndarray, compression: int, rps: int = 8, *,
             photometric: int = 0, fillorder: int = 1, more=None,
             pad: bytes = b"", chunks=None, **kw) -> bytes:
    """A striped fax TIFF written here: rows as fc.fax_strip writes them
    (kw: its options), or the chunks given."""
    h, w = rows.shape
    if chunks is None:
        chunks = chunks_of(rows, compression, rps, fillorder=fillorder, **kw)
    return tc.tiff_file(tags_of(w, h, compression, rps,
                                photometric=photometric, fillorder=fillorder,
                                more=more), chunks, pad=pad)


def tiled_fax(rows: np.ndarray, compression: int, tile=(16, 16), *,
              more=None, damage=None, **kw) -> bytes:
    """A tiled fax TIFF written here; damage: {tile: f(bytes) -> bytes}."""
    h, w = rows.shape
    tw, th = tile
    chunks = []
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            t = np.zeros((th, tw), np.uint8)
            part = rows[y0:y0 + th, x0:x0 + tw]
            t[:part.shape[0], :part.shape[1]] = part
            chunk = fc.fax_strip(t, compression, **kw)
            if damage and len(chunks) in damage:
                chunk = damage[len(chunks)](chunk)
            chunks.append(chunk)
    tags = {256: w, 257: h, 258: 1, 259: compression, 262: 0, 277: 1,
            322: tw, 323: th, 324: tc.CHUNKS, 325: tc.CHUNKS}
    tags.update(more or {})
    return tc.tiff_file(tags, chunks)


def thunder_file(pixels: np.ndarray, rps: int = 8, *, photometric: int = 1,
                 fillorder: int = 1, bps: int = 4, chunks=None, rng=None,
                 tile=None) -> bytes:
    """A ThunderScan TIFF through the writer's raw strips (or tiles)."""
    h, w = pixels.shape
    if chunks is None:
        if tile:
            tw, th = tile
            chunks = []
            for y0 in range(0, h, th):
                for x0 in range(0, w, tw):
                    t = np.zeros((th, tw), np.uint8)
                    part = pixels[y0:y0 + th, x0:x0 + tw]
                    t[:part.shape[0], :part.shape[1]] = part
                    chunks.append(fc.thunder(t, rng))
        else:
            chunks = [fc.thunder(pixels[y:y + rps], rng)
                      for y in range(0, h, rps)]
    if fillorder == 2:
        rev = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
        chunks = [c.translate(rev) for c in chunks]
    spec = dict(bps=bps, compression=THUNDER, photometric=photometric,
                fillorder=fillorder, raw=chunks)
    if tile:
        spec.update(tile_width=tile[0], tile_height=tile[1])
    else:
        spec.update(rows_per_strip=rps)
    return tc.libtiff(np.zeros((h, w, 1), np.uint8), **spec)


def _libtiff_cases(out: dict):
    rows = bilevel(1, 29, 37)
    for comp, name, opts in (
            (RLE, "rle", {}), (RLEW, "rlew", {}), (G3, "g3", {}),
            (G3, "g3_fill", {"t4options": 4}),
            (G3, "g3_2d", {"t4options": 1}),
            (G3, "g3_2d_fill", {"t4options": 5}), (G4, "g4", {})):
        for fo in (1, 2):
            for photo in (0, 1):
                out[f"fx_lw_{name}_p{photo}_fo{fo}_37x29.tif"] = lw(
                    rows, comp, photometric=photo, fillorder=fo,
                    rows_per_strip=8, **opts)
    for comp, name, opts in ((RLE, "rle", {}), (G3, "g3_2d",
                                                {"t4options": 1}),
                             (G4, "g4", {})):
        out[f"fx_lw_{name}_tiles_37x29.tif"] = lw(
            rows, comp, tile_width=16, tile_height=16, **opts)
    out["fx_lw_g4_palette_37x29.tif"] = lw(
        rows, G4, photometric=3,
        colormap=np.array([[65535, 0], [0, 32768], [16384, 65535]],
                          np.uint16))
    out["fx_lw_g4_orient6_37x29.tif"] = lw(rows, G4, orientation=6)
    out["fx_lw_g4_be_37x29.tif"] = lw(rows, G4, bigendian=1)
    out["fx_lw_g3_2d_bigtiff_37x29.tif"] = lw(rows, G3, bigtiff=1,
                                             t4options=1)
    out["fx_lw_g4_t6options2_37x29.tif"] = lw(rows, G4, t6options=2)
    # rows past 1728 and 2560 pixels: the extended make-up codes, and a
    # 2560 code repeated
    wide = np.zeros((3, 2700), np.uint8)
    wide[0, 2600:] = 1                  # white 2600: 2560 and 40
    wide[1, :1900] = 1                  # black 1856 and 44
    wide[2, 1000:] = 1                  # black 1700: 1664 and 36
    out["fx_lw_g4_2700x3.tif"] = lw(wide, G4)
    out["fx_lw_rle_2700x3.tif"] = lw(wide, RLE)
    out["fx_lw_g3_1800x3.tif"] = lw(bilevel(3, 3, 1800, block=450), G3)
    out["fx_lw_g3_2d_2000x3.tif"] = lw(bilevel(4, 3, 2000, block=500), G3,
                                      t4options=1)
    out["fx_lw_g4_1x5.tif"] = lw(bilevel(5, 5, 1, block=1), G4)
    out["fx_lw_g3_2d_9x4.tif"] = lw(bilevel(6, 4, 9, block=1), G3,
                                   t4options=1, rows_per_strip=3)
    # setup refusals: 8-bit samples (Pillow's L, RGB)
    grey = tc.picture(7, 5, 7, 1)
    out["fx_lw_g4_8bit_7x5.tif"] = tc.libtiff(grey, compression=1,
                                              rows_per_strip=5)
    out["fx_lw_g4_8bit_7x5.tif"] = tc.patched(out["fx_lw_g4_8bit_7x5.tif"],
                                              259, G4)
    rgb = tc.libtiff(tc.picture(8, 5, 7), photometric=2, rows_per_strip=5)
    out["fx_lw_rle_rgb_7x5.tif"] = tc.patched(rgb, 259, RLE)
    # YCbCr (Pillow reads it through TIFFRGBAImage, which goes on past a
    # strip that fails to decode, but not past a codec that fails setup)
    ycbcr = tc.patched(tc.libtiff(tc.picture(9, 8, 10), photometric=2,
                                  rows_per_strip=4), 262, 6)
    out["fx_lw_g4_ycbcr_10x8.tif"] = tc.patched(ycbcr, 259, G4)
    out["th_ycbcr_10x8.tif"] = tc.patched(ycbcr, 259, THUNDER)


def _group3_cases(out: dict):
    rows = bilevel(10, 13, 37)
    w = 37
    out["fx_hm_g3_no_first_eol_37x13.tif"] = fax_file(
        rows, G3, 13, eol_first=False)
    out["fx_hm_g3_rtc_37x13.tif"] = fax_file(rows, G3, 5, rtc=True)
    out["fx_hm_g3_2d_rtc_37x13.tif"] = fax_file(
        rows, G3, 5, rtc=True, two_d=True, more={292: 1})
    out["fx_hm_g3_2d_k2_fill_fo2_37x13.tif"] = fax_file(
        rows, G3, 13, two_d=True, k=2, fill_bits=True, fillorder=2,
        more={292: 5})
    # no EOL anywhere: libtiff finds none, and decodes the strip from its
    # first bit without EOLs
    bits = fc.Bits().put("".join(fc.row_1d(r) for r in rows)).pack()
    out["fx_hm_g3_no_eols_37x13.tif"] = fax_file(rows, G3, 13,
                                                 chunks=[bits])
    bits = fc.Bits().put("".join(fc.row_1d(r) for r in rows)).pack(2)
    out["fx_hm_g3_no_eols_fo2_37x13.tif"] = fax_file(
        rows, G3, 13, fillorder=2, chunks=[bits])
    # EOLs in the first rows only: at row 3 the decoder starts over from
    # the strip's first bit (its EOL ends that row at once), and the next
    # strip is read without EOLs
    head = fc.Bits()
    for r in rows[:3]:
        head.put(fc.EOL + fc.row_1d(r))
    head.put("".join(fc.row_1d(r) for r in rows[3:5]))
    out["fx_hm_g3_eols_stop_37x13.tif"] = fax_file(
        rows, G3, 5, chunks=[head.pack()] + chunks_of(rows[5:], G3, 5))
    # an EOL followed by zeros to the strip's end
    tail = fc.fax_strip(rows[:4], G3, tail=fc.EOL[:-1] + "0" * 20)
    out["fx_hm_g3_trailing_zeros_37x13.tif"] = fax_file(
        rows, G3, 5, chunks=[tail] + chunks_of(rows[5:], G3, 5))
    # 2D, one pixel a row: junk, a fill bit, an EOL and a 1D row that is
    # an EOL;
    # a 2D row whose VL3 (past b1) takes the data's last seven bits, read
    # whole; so the next row's EOL search starts with no bit left, and the
    # strip is refused (where bits are left, it reads on without EOLs)
    junk = fc.Bits().put("000001110000010" + fc.EOL + "1" + "0" * 11 +
                         fc.EOL[-1] + "0" + fc.VERTICAL[-3]).pack()
    out["fx_hm_g3_2d_no_bit_at_eol_1x4.tif"] = fax_file(
        np.zeros((4, 1), np.uint8), G3, 4, more={292: 1}, chunks=[junk])
    # 2D: the uncompressed-mode extension ends its row (a message), the
    # decode goes on
    out["fx_hm_g3_2d_uncompressed_37x13.tif"] = fax_file(
        rows, G3, 13, two_d=True, more={292: 1},
        codes={4: fc.UNCOMPRESSED + "1" * 9})
    # a bad white code word (8 zeros and a 1) in a 1D row; a bad black
    # code word
    r5 = fc.row_1d(rows[5])
    out["fx_hm_g3_bad_white_37x13.tif"] = fax_file(
        rows, G3, 13, codes={5: "000000001" + r5})
    first_white = fc.span(int(np.argmax(rows[6])), False)
    out["fx_hm_g3_bad_black_37x13.tif"] = fax_file(
        rows, G3, 13, codes={6: first_white + "000000001"})
    # rows too long and too short
    out["fx_hm_g3_long_row_37x13.tif"] = fax_file(
        rows, G3, 13, codes={2: fc.row_1d(rows[2]) + fc.span(9, True) +
                             fc.span(5, False)})
    out["fx_hm_g3_short_row_37x13.tif"] = fax_file(
        rows, G3, 13, codes={3: fc.span(10, False)})
    # 2D: an EOL after the row's first code ends it, the open (black) run
    # to the row's end
    out["fx_hm_g3_2d_eol_in_row_37x13.tif"] = fax_file(
        rows, G3, 13, two_d=True, more={292: 1},
        codes={5: fc.VERTICAL[0] + fc.EOL})
    out["fx_hm_g3_2d_long_row_37x13.tif"] = fax_file(
        rows, G3, 13, two_d=True, more={292: 1},
        codes={7: fc.row_2d(rows[7], rows[6]) + fc.HORIZ +
               fc.span(3, False) + fc.span(4, True)})
    # 2D: a VL whose b1 lies left of a0 + 1 (its reference row starts
    # black) ends the row
    r = next(y for y in range(1, 13) if rows[y - 1][0])
    out["fx_hm_g3_2d_bad_vl_37x13.tif"] = fax_file(
        rows, G3, 13, two_d=True, more={292: 1},
        codes={r: fc.VERTICAL[-1] + fc.row_2d(rows[r], rows[r - 1])})
    # strips cut where a code word ends on the data's last byte, every bit
    # read: the next code's read finds none left, and the strip is refused
    for name, codes, more in (
            ("g3", "0000" + fc.EOL, None),
            ("g3_2d", fc.EOL + "0" + fc.HORIZ, {292: 1})):
        out[f"fx_hm_{name}_cut_at_code_37x13.tif"] = fax_file(
            rows, G3, 8, more=more, chunks=[
                fc.fax_strip(rows[:8], G3, two_d=more is not None),
                fc.Bits().put(codes).pack()])
    # strips cut inside a code word: the bits left are padded with zeros,
    # which read as an EOL (so Group 3 goes on without EOLs from the
    # strip's start: read); RLE and RLEW drop them at the row's end (the
    # next row finds no bit left: refused)
    for name, comp, kw, more in (
            ("g3", G3, {}, None), ("g3_2d", G3, {"two_d": True}, {292: 1}),
            ("rle", RLE, {}, None), ("rlew", RLEW, {}, None)):
        full = fc.fax_strip(rows[:5], comp, **kw)
        out[f"fx_hm_{name}_cut_37x13.tif"] = fax_file(
            rows, comp, 5, more=more,
            chunks=[full[:len(full) // 2]] + chunks_of(rows[5:], comp, 5,
                                                       **kw))
    # T4Options: SHORT and IFD types read, a count of 2 ignored, the first
    # of two entries, on Group 4 and RLE ignored
    two_d = chunks_of(rows, G3, 13, two_d=True)
    for name, entry in (("short", [(292, 3, 1)]), ("ifd", [(292, 13, 1)]),
                        ("count2", [(292, 4, (1, 1))]),
                        ("signed", [(292, 9, 1)])):
        tags = list(tags_of(w, 13, G3, 13).items()) + entry
        out[f"fx_hm_g3_2d_t4_{name}_37x13.tif"] = tc.tiff_file(tags, two_d)
    tags = list(tags_of(w, 13, G3, 13).items()) + [(292, 4, 0),
                                                   (292, 4, 1)]
    out["fx_hm_g3_2d_t4_dup_first0_37x13.tif"] = tc.tiff_file(
        tags, two_d, sort=False)
    tags = list(tags_of(w, 13, G3, 13).items()) + [(292, 4, 1),
                                                   (292, 4, 0)]
    out["fx_hm_g3_2d_t4_dup_first1_37x13.tif"] = tc.tiff_file(
        tags, two_d, sort=False)
    out["fx_hm_rle_t4options1_37x13.tif"] = fax_file(rows, RLE, 13,
                                                     more={292: 1})
    out["fx_hm_g4_t4options1_37x13.tif"] = fax_file(rows, G4, 13,
                                                    more={292: 1})
    out["fx_hm_g4_predictor2_37x13.tif"] = fax_file(rows, G4, 13,
                                                    more={317: 2})


def _group4_cases(out: dict):
    rows = bilevel(20, 13, 37)
    out["fx_hm_g4_eofb_37x13.tif"] = fax_file(rows, G4, 5, eofb=True)
    out["fx_hm_g4_eofb_fo2_37x13.tif"] = fax_file(rows, G4, 5, eofb=True,
                                                  fillorder=2)
    # a premature end: in the first row, at a mode code (the data's last
    # byte used up), refused; in its last row, read
    first = (fc.HORIZ + fc.WHITE_TERM[2] + fc.BLACK_TERM[3] + fc.HORIZ +
             fc.WHITE_TERM[0] + fc.BLACK_TERM[5])
    out["fx_hm_g4_cut_first_row_37x13.tif"] = fax_file(
        rows, G4, 13, chunks=[fc.Bits().put(first).pack()])
    b = fc.Bits()
    ref = np.zeros(37, np.uint8)
    for r in rows[:12]:
        b.put(fc.row_2d(r, ref))
        ref = r
    b.put(fc.row_2d(rows[12], ref)[:5])
    out["fx_hm_g4_cut_last_row_37x13.tif"] = fax_file(
        rows, G4, 13, chunks=[b.pack()])
    # the second strip ends after its first row (EOFB, or the data cut):
    # its other rows keep the first strip's
    for name, second in (
            ("eofb", fc.fax_strip(rows[8:9], G4, eofb=True)),
            ("cut", fc.fax_strip(rows[8:9], G4))):
        out[f"fx_hm_g4_early_{name}_37x13.tif"] = fax_file(
            rows, G4, 8, chunks=[fc.fax_strip(rows[:8], G4), second])
    # T.6's uncompressed-mode extension and a bad code word in horizontal
    # mode end their rows
    out["fx_hm_g4_uncompressed_37x13.tif"] = fax_file(
        rows, G4, 13, codes={6: fc.UNCOMPRESSED + "1" * 12})
    out["fx_hm_g4_bad_horizontal_37x13.tif"] = fax_file(
        rows, G4, 8, chunks=[fc.fax_strip(rows[:8], G4), fc.fax_strip(
            rows[8:], G4, codes={1: fc.HORIZ + "000000001" +
                                 fc.row_2d(rows[9], rows[8])})])
    out["fx_hm_g4_long_row_37x13.tif"] = fax_file(
        rows, G4, 13, codes={3: fc.row_2d(rows[3], rows[2]) + fc.HORIZ +
                             fc.span(2, False) + fc.span(30, True)})
    # tiles: Group 3 2D and Group 4, each tile's reference line white; a
    # later tile cut (the tile read does not fail: its last rows keep the
    # tile before's)
    big = bilevel(21, 40, 45)
    out["fx_hm_g4_tiles_45x40.tif"] = tiled_fax(big, G4, (16, 16))
    out["fx_hm_g3_2d_tiles_45x40.tif"] = tiled_fax(
        big, G3, (32, 8), two_d=True, more={292: 1})
    # RLEW in tiles (libtiff's writer aligns its rows where its reader
    # does not, and the tile reads that then end early leave rows of the
    # first tile unwritten: Pillow's uninitialised memory)
    out["fx_hm_rlew_tiles_45x40.tif"] = tiled_fax(big, RLEW, (16, 16))
    out["fx_hm_g4_tiles_cut_45x40.tif"] = tiled_fax(
        big, G4, (16, 16), damage={4: lambda c: c[:len(c) // 3]})
    out["fx_hm_rle_tiles_cut_45x40.tif"] = tiled_fax(
        big, RLE, (16, 16), damage={2: lambda c: c[:len(c) // 2]})


def _rle_cases(out: dict):
    rows = bilevel(30, 11, 37)
    # RLEW aligns a row's end to the address of the next byte: the strip
    # at an odd offset and at an even one, both fill orders
    for fo in (1, 2):
        for pad in (b"", b"\0"):
            parity = "odd" if pad else "even"
            out[f"fx_hm_rlew_{parity}_fo{fo}_37x11.tif"] = fax_file(
                rows, RLEW, 11, fillorder=fo, pad=pad)
    # two strips, the first of odd length: the second starts at an odd
    # offset
    first = fc.fax_strip(rows[:6], RLEW)
    if len(first) % 2 == 0:
        first += b"\0"
    out["fx_hm_rlew_two_strips_37x11.tif"] = fax_file(
        rows, RLEW, 6, chunks=[first, fc.fax_strip(rows[6:], RLEW)])
    out["fx_hm_rlew_raw_strips_37x11.tif"] = lw(
        rows, RLEW, rows_per_strip=6,
        raw=[first, fc.fax_strip(rows[6:], RLEW)])
    # RLE whose rows are not byte-aligned (each row's pad dropped)
    bits = fc.Bits().put("".join(fc.row_1d(r) for r in rows)).pack()
    out["fx_hm_rle_unaligned_37x11.tif"] = fax_file(rows, RLE, 11,
                                                    chunks=[bits])
    out["fx_hm_rle_bad_code_37x11.tif"] = fax_file(
        rows, RLE, 11, codes={4: "0000000001" + fc.row_1d(rows[4])})
    out["fx_hm_rle_p1_fo2_odd_37x11.tif"] = fax_file(
        rows, RLE, 4, photometric=1, fillorder=2, pad=b"\0")


def _sgilog_cases(out: dict):
    px = tc.picture(40, 9, 11).astype(np.uint8)
    for comp in (SGILOG, SGILOG24):
        for photo, name, samples in ((1, "grey", px[..., :1]),
                                     (2, "rgb", px),
                                     (0, "bilevel", None)):
            if samples is None:
                data = lw(bilevel(41, 9, 11), 1, photometric=0)
            else:
                data = tc.libtiff(samples, photometric=photo,
                                  rows_per_strip=9)
            out[f"sg_{comp}_{name}_11x9.tif"] = tc.patched(data, 259, comp)
        for photo, name in ((32844, "logl"), (32845, "logluv")):
            spp = 1 if photo == 32844 else 3
            tags = tc.tags_for(11, 9, spp, 16, photo, comp, 9)
            out[f"sg_{comp}_{name}_11x9.tif"] = tc.tiff_file(
                tags, [bytes(range(200))])


def _thunder_cases(out: dict):
    px = nibbles(50, 29, 37)
    for photo in (0, 1):
        for fo in (1, 2):
            out[f"th_p{photo}_fo{fo}_37x29.tif"] = thunder_file(
                px, 8, photometric=photo, fillorder=fo,
                rng=np.random.default_rng(51 + 2 * photo + fo))
    out["th_palette_37x29.tif"] = tc.libtiff(
        np.zeros((29, 37, 1), np.uint8), bps=4, compression=THUNDER,
        photometric=3, rows_per_strip=29,
        colormap=np.arange(48, dtype=np.uint16).reshape(3, 16) * 1365,
        raw=[fc.thunder(px)])
    odd = nibbles(52, 7, 9)
    out["th_odd_9x7.tif"] = thunder_file(odd, 3,
                                         rng=np.random.default_rng(53))
    # codes written by hand, each row 8 pixels: runs (of 0, from an odd
    # pixel: the n == -1 fix-up), deltas with their skip codes, deltas
    # that wrap, a run that ends the row
    R, D2, D3, RAW = fc.RUN, fc.DELTA2, fc.DELTA3, fc.RAW
    rows = [
        [RAW | 5, R | 0, R | 3, RAW | 9, R | 3],
        [RAW | 1, R | 0, RAW | 2, R | 1, RAW | 3, R | 2, R | 2],
        [D2 | 0b011111, D2 | 0b100110, D2 | 0b111010, RAW | 4,
         D3 | 0b001010],
        [D3 | 0b001111, D3 | 0b100101, D3 | 0b010100, RAW | 12, R | 3],
        [RAW | 0, D2 | 0b111111, D3 | 0b111111, R | 2],
        [RAW | 15, D2 | 0b010101, D3 | 0b001001, R | 2],
        [RAW | 7, R | 7],
        [R | 8],
    ]
    out["th_codes_8x8.tif"] = thunder_file(
        np.zeros((8, 8), np.uint8), 8,
        chunks=[bytes(b for r in rows for b in r)])
    out["th_codes_fo2_8x8.tif"] = thunder_file(
        np.zeros((8, 8), np.uint8), 3, fillorder=2,
        chunks=[bytes(b for r in rows[i:i + 3] for b in r)
                for i in (0, 3, 6)])
    # a row's codes running past it: the rest read as the next row's
    out["th_extra_bytes_8x8.tif"] = thunder_file(
        np.zeros((8, 8), np.uint8), 8,
        chunks=[bytes(b for r in rows for b in r) + bytes((RAW | 3,) * 5)])
    # refused: a row short of its pixels, a run past them, 8 bits, tiles
    out["th_short_8x8.tif"] = thunder_file(
        np.zeros((8, 8), np.uint8), 8,
        chunks=[bytes(b for r in rows[:7] for b in r) + bytes((R | 3,))])
    out["th_run_past_row_8x8.tif"] = thunder_file(
        np.zeros((8, 8), np.uint8), 8,
        chunks=[bytes((RAW | 1, R | 9)) + bytes(b for r in rows[1:]
                                                for b in r)])
    out["th_8bit_37x29.tif"] = thunder_file(px, 8, bps=8)
    out["th_tiles_37x29.tif"] = thunder_file(px, tile=(16, 16),
                                             rng=np.random.default_rng(54))
    # tiles as wide as the image: ThunderDecodeRow's rows would fit them
    out["th_tiles_16x32.tif"] = thunder_file(px[:32, :16], tile=(16, 16),
                                             rng=np.random.default_rng(55))


def scene_pixels(rgb: np.ndarray) -> tuple:
    """The 640x480 scene as bilevel rows (1 black: luminance at most 40)
    and as 4-bit pixels (15 there, the luminance's top four bits
    elsewhere)."""
    lum = (rgb.astype(np.int32) @ np.array([299, 587, 114]) //
           1000).astype(np.uint8)
    return (lum <= 40).astype(np.uint8), \
        np.where(lum > 40, 15, lum >> 4).astype(np.uint8)


def scene_cases(rgb: np.ndarray) -> dict:
    """The committed 640x480 scenes for phase 9q."""
    rows, px = scene_pixels(rgb)
    th = fc.thunder(px)
    return {
        SCENES[0]: lw(rows, G4, rows_per_strip=480),
        ROTATED: lw(rows, G4, rows_per_strip=480, orientation=6),
        SCENES[1]: lw(rows, G3, rows_per_strip=64, fillorder=2,
                      t4options=5),
        SCENES[2]: lw(rows, RLE, rows_per_strip=64),
        THUNDER_SCENES[0]: thunder_file(px, 480, chunks=[th]),
        THUNDER_ROTATED: tc.libtiff(
            np.zeros((480, 640, 1), np.uint8), bps=4, compression=THUNDER,
            photometric=1, rows_per_strip=480, orientation=6, raw=[th]),
    }


def cases() -> dict:
    """Every committed file."""
    torch_jpeg_fixtures = _sibling("torch_jpeg_fixtures")
    out = {}
    _libtiff_cases(out)
    _group3_cases(out)
    _group4_cases(out)
    _rle_cases(out)
    _sgilog_cases(out)
    _thunder_cases(out)
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
