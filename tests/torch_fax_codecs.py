"""Test-side encoders of the TIFF codecs libtiff decodes in tif_fax3.c and
tif_thunder.c, for streams libtiff's own writer never makes.

- ``Bits``: a bit string, MSB first, packed into bytes for fill order 1 or
  (each byte's bits reversed) 2;
- the CCITT code words (T.4 and T.6): ``span`` (a run as make-up and
  terminating codes, libtiff's putspan), ``EOL``, the 2D modes, and
  ``row_1d``/``row_2d`` (a row as libtiff's Fax3Encode1DRow and
  Fax3Encode2DRow code it, against a reference row for 2D);
- ``fax_strip``: a strip or tile of rows as RLE (2), RLEW (32771), Group 3
  (3, 1D or 2D, with or without EOL fill bits, RTC) or Group 4 (4, EOFB),
  with hooks for the damage the corpus needs (a row's codes replaced,
  bits appended, the stream cut);
- ``thunder``: ThunderScan (32809), which libtiff cannot write: rows of
  4-bit pixels as runs, 2-bit and 3-bit deltas and raw pixels, each code
  a byte (its top two bits the code, the low six its data).

numpy only: chip_smoke.py makes its 640x480 scenes with it.
"""

import numpy as np

# T.4's code words, first bit first
WHITE_TERM = (
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111",
    "10011", "10100", "00111", "01000", "001000", "000011", "110100",
    "110101", "101010", "101011", "0100111", "0001100", "0001000",
    "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011",
    "00010010", "00010011", "00010100", "00010101", "00010110", "00010111",
    "00101000", "00101001", "00101010", "00101011", "00101100", "00101101",
    "00000100", "00000101", "00001010", "00001011", "01010010", "01010011",
    "01010100", "01010101", "00100100", "00100101", "01011000", "01011001",
    "01011010", "01011011", "01001010", "01001011", "00110010", "00110011",
    "00110100")
BLACK_TERM = (
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011",
    "000101", "000100", "0000100", "0000101", "0000111", "00000100",
    "00000111", "000011000", "0000010111", "0000011000", "0000001000",
    "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010",
    "000011001011", "000011001100", "000011001101", "000001101000",
    "000001101001", "000001101010", "000001101011", "000011010010",
    "000011010011", "000011010100", "000011010101", "000011010110",
    "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110",
    "000001010111", "000001100100", "000001100101", "000001010010",
    "000001010011", "000000100100", "000000110111", "000000111000",
    "000000100111", "000000101000", "000001011000", "000001011001",
    "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111")
# make-up codes of 64, 128, ..., 1728
WHITE_MAKEUP = (
    "11011", "10010", "010111", "0110111", "00110110", "00110111",
    "01100100", "01100101", "01101000", "01100111", "011001100",
    "011001101", "011010010", "011010011", "011010100", "011010101",
    "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000",
    "010011011")
BLACK_MAKEUP = (
    "0000001111", "000011001000", "000011001001", "000001011011",
    "000000110011", "000000110100", "000000110101", "0000001101100",
    "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101")
# the extended make-up codes both colours share: 1792, 1856, ..., 2560
EXT_MAKEUP = (
    "00000001000", "00000001100", "00000001101", "000000010010",
    "000000010011", "000000010100", "000000010101", "000000010110",
    "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111")
EOL = "000000000001"
PASS, HORIZ = "0001", "001"
# vertical modes by a1 - b1
VERTICAL = {0: "1", 1: "011", 2: "000011", 3: "0000011", -1: "010",
            -2: "000010", -3: "0000010"}
# the 2D extension code word, and T.6's uncompressed-mode extension
EXTENSION = "0000001"
UNCOMPRESSED = "0000001111"


class Bits:
    """A bit string written MSB first."""

    def __init__(self):
        self.bits = []

    def put(self, code: str) -> "Bits":
        self.bits.extend(1 if c == "1" else 0 for c in code)
        return self

    def align(self, n: int) -> "Bits":
        """Zero bits up to a multiple of n."""
        self.bits.extend([0] * (-len(self.bits) % n))
        return self

    def __len__(self) -> int:
        return len(self.bits)

    def pack(self, fillorder: int = 1) -> bytes:
        bits = np.array(self.bits + [0] * (-len(self.bits) % 8), np.uint8)
        out = np.packbits(bits) if bits.size else np.zeros(0, np.uint8)
        if fillorder == 2:
            out = np.packbits(np.unpackbits(out).reshape(-1, 8)[:, ::-1])
        return out.tobytes()


def span(run: int, black: bool) -> str:
    """libtiff's putspan: 2560-runs, one make-up code, a terminating code."""
    term = BLACK_TERM if black else WHITE_TERM
    makeup = BLACK_MAKEUP if black else WHITE_MAKEUP
    out = []
    while run >= 2624:
        out.append(EXT_MAKEUP[-1])
        run -= 2560
    if run >= 64:
        m = run & ~63
        out.append(EXT_MAKEUP[(m - 1792) // 64] if m >= 1792
                   else makeup[m // 64 - 1])
        run -= m
    out.append(term[run])
    return "".join(out)


def _finddiff(row: np.ndarray, bs: int, be: int, color: int) -> int:
    """The first position from bs on whose pixel is not color (be if
    none)."""
    while bs < be and row[bs] == color:
        bs += 1
    return bs


def _finddiff2(row: np.ndarray, bs: int, be: int, color: int) -> int:
    return _finddiff(row, bs, be, color) if bs < be else be


def row_1d(row: np.ndarray) -> str:
    """Fax3Encode1DRow: alternating white and black spans, white first."""
    bits, out, bs, color = len(row), [], 0, 0
    while True:
        span_end = _finddiff(row, bs, bits, color)
        out.append(span(span_end - bs, bool(color)))
        bs = span_end
        if bs >= bits:
            return "".join(out)
        color ^= 1


def row_2d(row: np.ndarray, ref: np.ndarray) -> str:
    """Fax3Encode2DRow: row (1 = black) against the reference row."""
    bits = len(row)

    def pixel(r, i):
        return int(r[i]) if i < bits else 0

    out = []
    a0 = 0
    a1 = 0 if pixel(row, 0) else _finddiff(row, 0, bits, 0)
    b1 = 0 if pixel(ref, 0) else _finddiff(ref, 0, bits, 0)
    while True:
        b2 = _finddiff2(ref, b1, bits, pixel(ref, b1))
        if b2 >= a1:
            d = b1 - a1
            if not -3 <= d <= 3:
                a2 = _finddiff2(row, a1, bits, pixel(row, a1))
                out.append(HORIZ)
                if a0 + a1 == 0 or pixel(row, a0) == 0:
                    out.append(span(a1 - a0, False) + span(a2 - a1, True))
                else:
                    out.append(span(a1 - a0, True) + span(a2 - a1, False))
                a0 = a2
            else:
                out.append(VERTICAL[a1 - b1])
                a0 = a1
        else:
            out.append(PASS)
            a0 = b2
        if a0 >= bits:
            return "".join(out)
        color = pixel(row, a0)
        a1 = _finddiff(row, a0, bits, color)
        b1 = _finddiff(ref, a0, bits, 1 - color)
        b1 = _finddiff(ref, b1, bits, color)


def fax_strip(rows: np.ndarray, compression: int, *, two_d: bool = False,
              k: int = 0, fill_bits: bool = False, rtc: bool = False,
              eofb: bool = False, eol_first: bool = True,
              codes: dict = None, fillorder: int = 1,
              cut_bits: int = None, tail: str = "") -> bytes:
    """A chunk of rows ((h, w) of 0 and 1, 1 black) as a fax codec writes
    it. compression 2 (rows byte-aligned, no EOL), 32771 (rows aligned to
    16 bits from the chunk's start), 3 (EOL before each row, with zero
    fill bits so that it ends a byte where fill_bits; two_d: a tag bit
    after each EOL, rows 2D but every k-th (k 0: the first alone) 1D; rtc:
    six EOLs at the end, each with its tag bit 1 in 2D), 4 (rows 2D, eofb:
    two EOLs at the end). codes: {row: code words} in place of a row's
    own; eol_first: the first row's EOL written; tail: bits written last;
    cut_bits: the stream cut to this many bits."""
    out = Bits()
    h, w = rows.shape
    ref = np.zeros(w, np.uint8)
    for y in range(h):
        row = rows[y]
        one_d = compression in (2, 32771) or (compression == 3 and (
            not two_d or (y % k == 0 if k else y == 0)))
        if compression == 3 and (y or eol_first):
            if fill_bits:
                out.put("0" * (-(len(out) + 12) % 8))
            out.put(EOL)
        if compression == 3 and two_d:
            out.put("1" if one_d else "0")
        if codes and y in codes:
            out.put(codes[y])
        elif compression == 4 or not one_d:
            out.put(row_2d(row, ref))
        else:
            out.put(row_1d(row))
        ref = row
        if compression == 2:
            out.align(8)
        elif compression == 32771:
            out.align(16)
    if compression == 3 and rtc:
        for _ in range(6):
            out.put(EOL + ("1" if two_d else ""))
    if compression == 4 and eofb:
        out.put(EOL + EOL)
    out.put(tail)
    if cut_bits is not None:
        out.bits = out.bits[:cut_bits]
    return out.pack(fillorder)


# -- ThunderScan --------------------------------------------------------------

# the code in a byte's top two bits; a delta field of 2 (2-bit) or 4
# (3-bit) is a skip code, no pixel
RUN, DELTA2, DELTA3, RAW = 0x00, 0x40, 0x80, 0xC0
_D2 = {0: 0, 1: 1, -1: 3}
_D3 = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}


def thunder_row(row: np.ndarray, rng=None) -> bytes:
    """A row of 4-bit pixels as ThunderScan codes: runs of the last pixel
    (up to 63), three 2-bit deltas, two 3-bit deltas, raw pixels; rng
    picks among the codes that fit (None: the shortest)."""
    out = bytearray()
    last, i, n = 0, 0, len(row)
    while i < n:
        v = int(row[i])
        options = []
        run = 0
        while i + run < n and run < 63 and int(row[i + run]) == last:
            run += 1
        if run:
            options.append(("run", run))
        if i + 2 < n and int(row[i]) - last in _D2 and \
                int(row[i + 1]) - int(row[i]) in _D2 and \
                int(row[i + 2]) - int(row[i + 1]) in _D2:
            options.append(("d2", 3))
        if i + 1 < n and v - last in _D3 and int(row[i + 1]) - v in _D3:
            options.append(("d3", 2))
        options.append(("raw", 1))
        kind, count = options[0] if rng is None else \
            options[int(rng.integers(len(options)))]
        if kind == "run":
            if rng is not None:
                count = int(rng.integers(1, count + 1))
            out.append(RUN | count)
        elif kind == "d2":
            a, b, c = (int(row[i]) - last, int(row[i + 1]) - int(row[i]),
                       int(row[i + 2]) - int(row[i + 1]))
            out.append(DELTA2 | _D2[a] << 4 | _D2[b] << 2 | _D2[c])
            v = int(row[i + 2])
        elif kind == "d3":
            a, b = v - last, int(row[i + 1]) - v
            out.append(DELTA3 | _D3[a] << 3 | _D3[b])
            v = int(row[i + 1])
        else:
            out.append(RAW | v)
        i += count
        last = v
    return bytes(out)


def thunder(rows: np.ndarray, rng=None) -> bytes:
    """A chunk of rows ((h, w) of 4-bit pixels) as ThunderScan."""
    return b"".join(thunder_row(r, rng) for r in rows)

