"""The PNM corpus (tests/fixtures/torch_pnm_corpus/): files the JAX package
hands to Pillow 12.1.0, whose PpmImagePlugin reads them, and which the port
reads in data/pnm.py.

Small files made from numpy seeds, one for each case the port must take as
Pillow takes it:

- Pillow's writer: P4 (mode 1), P5 at 255 (L) and at 65535 (I;16 and I),
  P6 (RGB, and RGBA saved as RGB), Pf (F, little-endian);
- written here: plain P1-P3 and binary P5-P6 at maxvals 1, 6, 15, 100,
  255, 256, 300, 1000, 65534 and 65535 (6 has ties that Pillow's round
  breaks to even; bytes above maxval clip), Pf in both byte orders with
  NaN, infinities and fractions, P0CMYK, PyCMYK, PyRGBA and PyP;
- headers: the magic number up to whitespace, comments inside and after
  tokens, CR as a line end, signs and underscores that Python's int
  reads, tokens of 10 and 11 bytes, maxvals and scales out of range,
  widths of 0, a comment after maxval running into the data, a header
  past the 64 KiB prefix sizes are read from, the decompression-bomb
  limit;
- plain data: comments that join tokens, values above maxval, negative
  and over-long tokens, bad P1 bytes before and after the image's end,
  a file cut inside its last token;
- cut files of every decoder, and trailing bytes.

``digests.json`` holds, for each file, the sha256 of each JAX route's
pixels on this machine, null where it fails (tests/torch_pillow_corpus.py
:reference): ``loader`` is the JAX server's ``_decode_image`` (the server,
the loader, detect ``--all``; for PNM, Pillow), ``img`` is
``np.asarray(Image.open(f).convert("RGB"))`` (detect ``--img``), and
``hw`` the (h, w) Pillow's open reads.
``scene_digests.json`` holds the same for the 640x480 scenes
(``scene_cases``), which are made at run time from
tests/torch_jpeg_fixtures.py:scene 0 with numpy alone, so chip_smoke.py
remakes them on the card (this module imports neither Pillow nor another
test module until ``write`` runs). ``boundary_cases`` makes plain files
whose tokens and comments meet the 1 MiB blocks of Pillow's plain
decoder.
``chip_smoke.py`` holds the port to the digests on a machine without
Pillow. Remake the corpus (Pillow and the JAX package needed) with

  python -m tests.torch_pnm_corpus [folder]

File names give the width before the height.
"""

import io
import json
import os
import sys

import numpy as np

FOLDER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                      "torch_pnm_corpus")
DIGESTS = "digests.json"
SCENE_DIGESTS = "scene_digests.json"
SAFEBLOCK = 1024 * 1024          # Pillow's ImageFile.SAFEBLOCK


# -- writers ------------------------------------------------------------------

def picture(seed: int, h: int, w: int, channels: int = 3,
            high: int = 256) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, high, (h, w, channels), np.int64)


def header(magic: bytes, w: int, h: int, *more) -> bytes:
    return magic + b"\n%d %d\n" % (w, h) + b"".join(
        (m if isinstance(m, bytes) else b"%d" % m) + b"\n" for m in more)


def plain(values, per_line: int = 17) -> bytes:
    """Values as ASCII tokens, per_line to a line."""
    flat = [b"%d" % v for v in np.asarray(values).ravel().tolist()]
    return b"".join(b" ".join(flat[i:i + per_line]) + b"\n"
                    for i in range(0, len(flat), per_line))


def binary(values, maxval: int) -> bytes:
    """Samples as Pillow's ppm decoder reads them: 1 byte below maxval 256,
    else 2 big-endian."""
    return np.asarray(values).astype(">u2" if maxval >= 256 else np.uint8
                                     ).tobytes()


def bits(pixels: np.ndarray) -> bytes:
    """P4 rows: 1 is black, each row padded to a byte."""
    return np.packbits(pixels.astype(np.uint8), axis=1).tobytes()


def pillow_written(arr: np.ndarray) -> bytes:
    """Bytes from Pillow's own PPM writer, of the mode Image.fromarray
    gives the array."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PPM")
    return buf.getvalue()


def pfm(values: np.ndarray, scale: bytes) -> bytes:
    """A Pf file: rows bottom to top, little-endian under a negative scale."""
    h, w = values.shape
    dtype = "<f4" if scale.startswith(b"-") else ">f4"
    return b"Pf\n%d %d\n%s\n" % (w, h, scale) + np.ascontiguousarray(
        values[::-1]).astype(dtype).tobytes()


# -- the corpus ---------------------------------------------------------------

MAXVALS = (1, 6, 15, 100, 255, 256, 300, 1000, 65534, 65535)


def _writer_cases(out: dict):
    rgb = picture(1, 23, 37).astype(np.uint8)
    out["pillow_p4_37x23.pbm"] = pillow_written(rgb[..., 0] > 127)
    out["pillow_p5_l_37x23.pgm"] = pillow_written(rgb[..., 0])
    out["pillow_p5_i16_37x23.pgm"] = pillow_written(
        picture(2, 23, 37, 1, 65536)[..., 0].astype(np.uint16))
    out["pillow_p5_i_low_37x23.pgm"] = pillow_written(
        picture(3, 23, 37, 1, 300)[..., 0].astype(np.int32))
    out["pillow_p6_37x23.ppm"] = pillow_written(rgb)
    out["pillow_p6_rgba_37x23.ppm"] = pillow_written(
        picture(4, 23, 37, 4).astype(np.uint8))
    f = (np.random.default_rng(5).standard_normal((23, 37)) * 150 + 100
         ).astype(np.float32)
    out["pillow_pf_37x23.pfm"] = pillow_written(f)


def _maxval_cases(out: dict):
    for m in MAXVALS:
        hi = min(m + 1, 65536)
        grey = picture(10 + m, 9, 13, 1, hi)[..., 0]
        rgb = picture(11 + m, 9, 13, 3, hi)
        out[f"p2_maxval{m}_13x9.pgm"] = header(b"P2", 13, 9, m) + plain(grey)
        out[f"p3_maxval{m}_13x9.ppm"] = header(b"P3", 13, 9, m) + plain(rgb)
        out[f"p5_maxval{m}_13x9.pgm"] = header(b"P5", 13, 9, m) + binary(
            grey, m)
        out[f"p6_maxval{m}_13x9.ppm"] = header(b"P6", 13, 9, m) + binary(
            rgb, m)
    # bytes above maxval clip in the ppm decoder
    for m in (6, 100, 1000):
        top = 256 if m < 256 else 65536
        out[f"p6_above_maxval{m}_13x9.ppm"] = header(
            b"P6", 13, 9, m) + binary(picture(12, 9, 13, 3, top), m)
        out[f"p5_above_maxval{m}_13x9.pgm"] = header(
            b"P5", 13, 9, m) + binary(picture(13, 9, 13, 1, top), m)


def _format_cases(out: dict):
    px = picture(20, 7, 19, 1, 2)[..., 0]
    out["p1_19x7.pbm"] = header(b"P1", 19, 7) + plain(px)
    out["p1_packed_19x7.pbm"] = header(b"P1", 19, 7) + b"".join(
        b"".join(b"%d" % v for v in row) + b"\n" for row in px.tolist())
    out["p4_19x7.pbm"] = header(b"P4", 19, 7) + bits(px)
    out["p4_16x3.pbm"] = header(b"P4", 16, 3) + bits(
        picture(21, 3, 16, 1, 2)[..., 0])
    special = np.array([0.6, 1.5, 254.5, 255.4, -3, np.nan, np.inf, -np.inf,
                        255.99, 256, -0.5, 127.5, 1e10, -1e10, 0, 1],
                       np.float32)
    f = np.concatenate([special, (np.random.default_rng(22).standard_normal(
        5 * 16 - 16) * 120 + 120).astype(np.float32)]).reshape(5, 16)
    out["pf_le_16x5.pfm"] = pfm(f, b"-1.0")
    out["pf_be_16x5.pfm"] = pfm(f, b"1.0")
    out["pf_be_scale2.5_16x5.pfm"] = pfm(f, b"2.5")
    out["pf_le_scale_exp_16x5.pfm"] = pfm(f, b"-1e-3")
    cmyk = picture(23, 6, 11, 4)
    out["p0cmyk_11x6.ppm"] = header(b"P0CMYK", 11, 6, 255) + binary(cmyk, 255)
    out["p0cmyk_maxval1000_11x6.ppm"] = header(b"P0CMYK", 11, 6, 1000) + \
        binary(picture(24, 6, 11, 4, 1001), 1000)
    out["pycmyk_11x6.ppm"] = header(b"PyCMYK", 11, 6, 255) + binary(cmyk, 255)
    out["pyrgba_11x6.ppm"] = header(b"PyRGBA", 11, 6, 255) + binary(
        picture(25, 6, 11, 4), 255)
    out["pyrgba_maxval100_11x6.ppm"] = header(b"PyRGBA", 11, 6, 100) + \
        binary(picture(26, 6, 11, 4, 101), 100)
    out["pyp_11x6.ppm"] = header(b"PyP", 11, 6, 255) + binary(
        picture(27, 6, 11, 1), 255)
    out["pyp_maxval300_11x6.ppm"] = header(b"PyP", 11, 6, 300) + binary(
        picture(28, 6, 11, 1, 301), 300)


def _header_cases(out: dict):
    six = bytes(range(1, 7))
    sixty = bytes(range(60))
    # the re-anchor's table: files the port read or refused against Pillow
    out["hdr_magic_comment_2x1.ppm"] = b"P6#x\n2 1 255\n" + six
    out["hdr_magic_no_space_2x1.ppm"] = b"P62 1 255\n" + six
    out["hdr_token_11_bytes_2x1.ppm"] = b"P6 00000000002 1 255\n" + six
    out["hdr_comment_in_token_20x1.ppm"] = b"P6 2#c\n0 1 255\n" + sixty
    out["hdr_plus_width_2x1.ppm"] = b"P6 +2 1 255\n" + six
    out["hdr_p5_2x1.pgm"] = b"P5 2 1 255\n\x01\x02"
    out["hdr_p3_1x1.ppm"] = b"P3 1 1 255\n1 2 3\n"
    out["hdr_maxval100_1x1.ppm"] = b"P6 1 1 100\n\x01\x02\x03"
    # more of _read_magic, _read_token and int()
    out["hdr_token_10_bytes_2x1.ppm"] = b"P6 0000000002 1 255\n" + six
    out["hdr_underscore_20x1.ppm"] = b"P6 2_0 1 255\n" + sixty
    out["hdr_comment_cr_2x1.ppm"] = b"P6 2 #c\r1 255\n" + six
    out["hdr_comment_crlf_2x0.ppm"] = b"P6 2#c\r\n0 1 255\n" + \
        sixty
    out["hdr_vt_ff_2x1.ppm"] = b"P6\x0b2\x0c1\t255\r" + six
    out["hdr_magic_6_bytes_2x1.ppm"] = b"P0CMYK2 1 255\n" + bytes(8)
    out["hdr_magic_pf_upper_2x1.pfm"] = b"PF\n2 1\n-1.0\n" + bytes(24)
    out["hdr_magic_p7_2x1.pam"] = b"P7\n2 1\n255\n" + six
    out["hdr_magic_py_2x1.ppm"] = b"Py\n2 1\n255\n" + six
    out["hdr_width0_0x1.ppm"] = b"P6 0 1 255\n" + six
    out["hdr_height_negative_2x-1.ppm"] = b"P6 2 -1 255\n" + six
    out["hdr_maxval0_2x1.ppm"] = b"P6 2 1 0\n" + six
    out["hdr_maxval65536_2x1.ppm"] = b"P6 2 1 65536\n" + bytes(12)
    out["hdr_maxval_plus_2x1.ppm"] = b"P6 2 1 +255\n" + six
    out["hdr_width_x_2x1.ppm"] = b"P6 2x 1 255\n" + six
    out["hdr_eof_in_header_2x1.ppm"] = b"P6 2 1"
    out["hdr_eof_after_maxval_2x1.ppm"] = b"P6 2 1 255"
    out["hdr_comment_after_maxval_3x1.pgm"] = b"P5 3 1 255#x\n\x41\x42\x43"
    out["hdr_comment_after_maxval_space_3x1.pgm"] = \
        b"P5 3 1 255#x\n \x41\x42\x43"
    out["hdr_data_after_cr_3x1.pgm"] = b"P5 3 1 255\r\n\x41\x42\x43"
    out["hdr_pf_scale0_2x1.pfm"] = b"Pf 2 1 0.0\n" + bytes(8)
    out["hdr_pf_scale_nan_2x1.pfm"] = b"Pf 2 1 nan\n" + bytes(8)
    out["hdr_pf_scale_inf_2x1.pfm"] = b"Pf 2 1 -inf\n" + bytes(8)
    out["hdr_pf_scale_underscore_2x1.pfm"] = b"Pf 2 1 -1_0\n" + bytes(8)
    out["hdr_long_comment_3x2.pgm"] = b"P5 #" + b"c" * 70000 + \
        b"\n3 2 255\n" + six
    # P4's last header token, its height, ends at the 64 KiB that sizes are
    # first read from: 1 there, 12 in the whole file
    out["hdr_p4_height_at_prefix_end_3x12.pbm"] = b"P4 3 #" + \
        b"c" * 65528 + b"\n12\n" + bytes(12)
    out["hdr_bomb_20000x20000.pgm"] = b"P5 20000 20000 255\n" + six
    out["hdr_under_bomb_10000x10000.pgm"] = b"P5 10000 10000 255\n" + six


def _plain_cases(out: dict):
    out["p2_comment_joins_2x1.pgm"] = b"P2 2 1 9999\n12#c\n34 5\n"
    out["p2_comment_cr_joins_2x1.pgm"] = b"P2 2 1 9999\n1#c\r2 5\n"
    out["p2_comment_between_2x1.pgm"] = b"P2 2 1 255\n12 #c\n34\n"
    out["p2_above_maxval_2x1.pgm"] = b"P2 2 1 100\n50 101\n"
    out["p2_negative_2x1.pgm"] = b"P2 2 1 100\n50 -1\n"
    out["p2_minus_zero_2x1.pgm"] = b"P2 2 1 100\n50 -0\n"
    out["p2_plus_underscore_2x1.pgm"] = b"P2 2 1 1000\n+5 1_00\n"
    out["p2_token_11_bytes_2x1.pgm"] = b"P2 2 1 100\n50 00000000001\n"
    out["p2_token_10_bytes_2x1.pgm"] = b"P2 2 1 100\n50 0000000001\n"
    out["p2_junk_token_2x1.pgm"] = b"P2 2 1 100\n50 x\n"
    out["p2_junk_after_end_2x1.pgm"] = b"P2 2 1 100\n50 60 x 00000000001\n"
    out["p2_short_3x1.pgm"] = b"P2 3 1 100\n50 60\n"
    out["p3_cut_in_last_token_1x1.ppm"] = b"P3 1 1 255\n1 2 25"
    out["p3_no_final_space_1x1.ppm"] = b"P3 1 1 255\n1 2 255"
    out["p1_bad_byte_3x1.pbm"] = b"P1 3 1\n0 2 1\n"
    out["p1_bad_after_end_3x1.pbm"] = b"P1 3 1\n0 1 1 2\n"
    out["p1_comment_3x1.pbm"] = b"P1 3 1\n0#c\n1 1\n"
    out["p1_short_3x1.pbm"] = b"P1 3 1\n0 1\n"


def _cut_cases(out: dict):
    for name in ("p5_maxval255_13x9.pgm", "p5_maxval65535_13x9.pgm",
                 "p6_maxval255_13x9.ppm", "p6_maxval1000_13x9.ppm",
                 "p4_19x7.pbm", "pf_le_16x5.pfm", "pyrgba_11x6.ppm",
                 "p0cmyk_11x6.ppm", "p3_maxval255_13x9.ppm",
                 "p1_19x7.pbm"):
        data = out[name]
        cut = len(data) - (3 if name.startswith(("p3", "p1")) else 1)
        out["cut_" + name] = data[:cut]
    out["trailing_p6_maxval255_13x9.ppm"] = out["p6_maxval255_13x9.ppm"] + \
        b"trailing garbage"
    out["trailing_p5_maxval1000_13x9.pgm"] = out[
        "p5_maxval1000_13x9.pgm"] + b"\x00\x01"


def cases() -> dict:
    """{file name: bytes}."""
    out = {}
    _writer_cases(out)
    _maxval_cases(out)
    _format_cases(out)
    _header_cases(out)
    _plain_cases(out)
    _cut_cases(out)
    return out


# -- generated at run time ----------------------------------------------------

def _plain_bytes(values: np.ndarray, sep: bytes = b" ") -> bytes:
    table = [b"%d" % v for v in range(int(values.max()) + 1)]
    return sep.join(table[v] for v in values.ravel().tolist()) + b"\n"


def scene_cases(rgb: np.ndarray) -> dict:
    """A 640x480 scene (tests/torch_jpeg_fixtures.py:scene 0) as P6 at
    255, P6 at maxval 1000, a 16-bit P5 whose grey stays below 256, plain
    P3, plain P1 (the grey thresholded at its mean) and Pf (the grey plus
    a quarter, little-endian): numpy only."""
    h, w = rgb.shape[:2]
    grey = rgb.astype(np.int64).sum(-1) // 3
    wide = np.round(rgb.astype(np.float64) * 1000 / 255).astype(np.int64)
    return {
        "scene_p6_640x480.ppm": header(b"P6", w, h, 255) + rgb.tobytes(),
        "scene_p6_maxval1000_640x480.ppm": header(b"P6", w, h, 1000) +
        binary(wide, 1000),
        "scene_p5_16bit_640x480.pgm": header(b"P5", w, h, 65535) +
        binary(grey, 65535),
        "scene_p3_640x480.ppm": header(b"P3", w, h, 255) + _plain_bytes(
            rgb.astype(np.int64)),
        "scene_p1_640x480.pbm": header(b"P1", w, h) + _plain_bytes(
            (grey < grey.mean()).astype(np.int64), b""),
        "scene_pf_640x480.pfm": pfm(grey.astype(np.float32) + 0.25, b"-1.0"),
    }


def boundary_cases() -> dict:
    """Plain files whose data meets the end of the plain decoder's first
    1 MiB block: a comment filler takes the data up to a few bytes before
    it, then tokens, comments or line ends straddle it."""
    def file(head: bytes, tail: bytes, before: int) -> bytes:
        # tail starts `before` bytes ahead of the block's end
        fill = SAFEBLOCK - before - 2
        return head + b"#" + b"f" * fill + b"\n" + tail

    p2 = b"P2 3 1 65535\n"
    return {
        # a token cut by the block's end carries over to the next block
        "bnd_half_token_3x1.pgm": file(p2, b"12345 6 7\n", 3),
        # a comment that starts in block 1 and ends in block 2 joins the
        # tokens either side
        "bnd_comment_across_3x1.pgm": file(p2, b"12#abcdef\n34 5 6\n", 4),
        # block 2 starts with LF and holds a CR later: Pillow's
        # _find_comment_end takes the CR, so the comment runs on to it
        "bnd_lf_first_3x1.pgm": file(p2, b"1 #ab\n2 3\r4 5 6\n", 5),
        "bnd_cr_first_3x1.pgm": file(p2, b"1 #ab\r2 3\n4 5 6\n", 5),
        # a comment that spans all of block 2
        "bnd_comment_spans_block_3x1.pgm": file(
            p2, b"7 #" + b"s" * (SAFEBLOCK + 16) + b"\n8 9\n", 5),
        # P1: a bad byte after the image's end is checked in its block only
        "bnd_p1_bad_next_block_3x1.pbm": file(b"P1 3 1\n", b"0 1 1 2", 5),
        "bnd_p1_bad_same_block_3x1.pbm": file(b"P1 3 1\n", b"0 1 1 2", 9),
        # a token over 10 bytes at a block's end is refused, though the
        # image ends before it
        "bnd_long_half_token_3x1.pgm": file(
            p2, b"1 2 3 " + b"0" * 12 + b"4\n", 18),
        "bnd_half_token_10_bytes_3x1.pgm": file(
            p2, b"1 2 0000000009 4\n", 14),
    }


def load(folder: str = FOLDER, name: str = DIGESTS) -> dict:
    with open(os.path.join(folder, name)) as f:
        return json.load(f)


def _dump(path: str, digests: dict):
    with open(path, "w") as f:
        f.write("{\n" + ",\n".join(
            f" {json.dumps(k)}: {json.dumps(v, sort_keys=True)}"
            for k, v in digests.items()) + "\n}\n")


def write(folder: str = FOLDER) -> dict:
    """Write every case, digests.json and scene_digests.json into folder;
    returns the digests."""
    from tests import torch_jpeg_fixtures
    from tests.torch_pillow_corpus import reference

    os.makedirs(folder, exist_ok=True)
    digests = {}
    for name, data in sorted(cases().items()):
        with open(os.path.join(folder, name), "wb") as f:
            f.write(data)
        digests[name] = reference(data)
    _dump(os.path.join(folder, DIGESTS), digests)
    _dump(os.path.join(folder, SCENE_DIGESTS),
          {n: reference(d) for n, d in sorted(scene_cases(
              torch_jpeg_fixtures.scene(0)).items())})
    return digests


if __name__ == "__main__":
    print(json.dumps(write(*sys.argv[1:]), indent=1, sort_keys=True))
