"""A writer of legacy zstd frames (v0.5, v0.6 and v0.7), for the tests.

libzstd 1.5.7 still decodes frames of these three formats (built with
legacy support down to v0.5), but no library here writes them. This module
writes them as their decoders read them (zstd_v05.c, zstd_v06.c,
zstd_v07.c): the frame header, raw, RLE, end and compressed blocks, and in
a compressed block each literals mode (raw, RLE, Huffman in one or four
streams from a table of one or two symbols a lookup, v0.7's repeated table)
and each sequence-table mode (v0.5's raw codes, the predefined
distributions of v0.6 and v0.7, RLE, FSE, the previous block's), with each
version's repeat offsets. Every piece is built from what the decoder reads:
an FSE stream is the chain of states the decoding table walks, a Huffman
code is the table's own. Whether a frame is valid is the library's call:
``tests/torch_tiff_zstd_legacy_corpus.py`` checks every frame it writes
against libzstd through ctypes.

Run as a module to print a frame of each version and what libzstd makes of
it: ``python -m tests.torch_zstd_legacy``.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

MAGIC = {5: 0xFD2FB525, 6: 0xFD2FB526, 7: 0xFD2FB527}
BLOCK = 128 * 1024

# -- the backward bit stream -----------------------------------------------------


def bitstream(reads: Sequence[Tuple[int, int]]) -> bytes:
    """A stream whose decoder reads (value, nbits) in this order: written
    last to first, then the end mark."""
    acc, pos = 0, 0
    for value, nbits in reversed(reads):
        if nbits:
            acc |= (value & ((1 << nbits) - 1)) << pos
            pos += nbits
    acc |= 1 << pos
    pos += 1
    return acc.to_bytes((pos + 7) // 8, "little")


def _highbit(v: int) -> int:
    return v.bit_length() - 1


# -- FSE ---------------------------------------------------------------------------


def normalize(counts: Dict[int, int], log: int,
              low: bool = False) -> List[int]:
    """Counts normalized to 2^log (each present symbol at least 1; with
    low, the rarest at -1, FSE's low-probability mark)."""
    size = 1 << log
    top = max(counts)
    total = sum(counts.values())
    norm = [0] * (top + 1)
    rare = min(counts, key=lambda s: (counts[s], s)) if low and \
        len(counts) > 2 else None
    for s, c in counts.items():
        norm[s] = -1 if s == rare else max(1, c * size // total)
    big = max(counts, key=lambda s: (norm[s], -s))
    norm[big] += size - sum(abs(v) for v in norm)
    if norm[big] < 1:
        raise ValueError("too many symbols for the table")
    return norm


def write_ncount(norm: Sequence[int], log: int) -> bytes:
    """FSE_writeNCount."""
    acc, pos = log - 5, 4
    remaining, threshold, nbits = (1 << log) + 1, 1 << log, log + 1
    symbol, previous0 = 0, False
    n = len(norm)
    while symbol < n and remaining > 1:
        if previous0:
            start = symbol
            while symbol < n and not norm[symbol]:
                symbol += 1
            while symbol >= start + 24:
                start += 24
                acc |= 0xFFFF << pos
                pos += 16
            while symbol >= start + 3:
                start += 3
                acc |= 3 << pos
                pos += 2
            acc |= (symbol - start) << pos
            pos += 2
        count = norm[symbol]
        symbol += 1
        top = (2 * threshold - 1) - remaining
        remaining -= abs(count)
        count += 1
        if count >= threshold:
            count += top
        acc |= count << pos
        pos += nbits - (count < top)
        previous0 = count == 1
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1:
        raise ValueError("not a normalized distribution")
    return acc.to_bytes((pos + 7) // 8, "little")


class Fse:
    """A decoding table as FSEv0x_buildDTable builds it, and the encoder
    that walks it backwards."""

    def __init__(self, norm: Sequence[int], log: int):
        size = 1 << log
        high = size - 1
        symbol = [0] * size
        nxt = {}
        for s, v in enumerate(norm):
            if v == -1:
                symbol[high] = s
                high -= 1
                nxt[s] = 1
            else:
                nxt[s] = v
        step, pos = (size >> 1) + (size >> 3) + 3, 0
        for s, v in enumerate(norm):
            for _ in range(max(v, 0)):
                symbol[pos] = s
                pos = (pos + step) & (size - 1)
                while pos > high:
                    pos = (pos + step) & (size - 1)
        self.log = log
        self.cells = []
        for u in range(size):
            s = symbol[u]
            ns = nxt[s]
            nxt[s] += 1
            nb = log - _highbit(ns)
            self.cells.append(((ns << nb) - size, s, nb))
        self.by_symbol: Dict[int, list] = {}
        for u, (base, s, nb) in enumerate(self.cells):
            self.by_symbol.setdefault(s, []).append((base, nb, u))

    @classmethod
    def rle(cls, symbol: int) -> "Fse":
        t = cls.__new__(cls)
        t.log = 0
        t.cells = [(0, symbol, 0)]
        t.by_symbol = {symbol: [(0, 0, 0)]}
        return t

    @classmethod
    def raw(cls, nbits: int) -> "Fse":
        t = cls.__new__(cls)
        t.log = nbits
        t.cells = [(0, u, nbits) for u in range(1 << nbits)]
        t.by_symbol = {u: [(0, nbits, u)] for u in range(1 << nbits)}
        return t

    def walk(self, codes: Sequence[int], final: Optional[int] = None):
        """(the first state, the (bits, nbits) of each update) that decode
        codes: every update but the last's, or with final, also the last
        one, to that state."""
        n = len(codes)
        states = [0] * (n + 1)
        if final is None:
            # the last state: one of the most bits (FSE_initCState2's), so
            # that a decoder of unknown length overflows its stream there
            states[n - 1] = max(self.by_symbol[codes[-1]],
                                key=lambda c: c[1])[2]
            first = n - 2
        else:
            states[n] = final
            first = n - 1
        updates = [None] * (first + 1)
        tables: Dict[int, dict] = {}
        for i in range(first, -1, -1):
            target = states[i + 1]
            table = tables.get(codes[i])
            if table is None:
                table = tables[codes[i]] = self._leading(codes[i])
            cell = table.get(target)
            if cell is None:
                raise ValueError("no state leads there")
            base, nb, u = cell
            states[i] = u
            updates[i] = (target - base, nb)
        return states[0], updates

    def _leading(self, symbol: int) -> dict:
        """target state -> the first of symbol's cells (in by_symbol's
        order) whose range holds it, built once a symbol."""
        cache = self.__dict__.setdefault("_leads", {})
        table = cache.get(symbol)
        if table is None:
            table = {}
            for base, nb, u in self.by_symbol[symbol]:
                for target in range(base, base + (1 << nb)):
                    table.setdefault(target, (base, nb, u))
            cache[symbol] = table
        return table


def fse_table(codes: Sequence[int], max_log: int, low: bool = False):
    """A table for codes: (Fse, its NCount bytes)."""
    counts: Dict[int, int] = {}
    for c in codes:
        counts[c] = counts.get(c, 0) + 1
    log = max(5, min(max_log, _highbit(max(len(codes), 1)) + 1))
    while log < max_log and (1 << log) < 2 * len(counts):
        log += 1
    norm = normalize(counts, log, low)
    return Fse(norm, log), write_ncount(norm, log)


# -- Huffman -------------------------------------------------------------------


def code_lengths(counts: Dict[int, int], limit: int = 11) -> Dict[int, int]:
    """Length-limited Huffman code lengths (package-merge)."""
    items = sorted((c, s) for s, c in counts.items())
    if len(items) < 2:
        raise ValueError("a Huffman table needs two symbols")
    lengths = {s: 0 for _, s in items}
    packages: list = [[(c, [s]) for c, s in items]]
    current = list(packages[0])
    for _ in range(limit - 1):
        merged = [(current[i][0] + current[i + 1][0],
                   current[i][1] + current[i + 1][1])
                  for i in range(0, len(current) - 1, 2)]
        current = sorted(packages[0] + merged, key=lambda x: x[0])
    for _, symbols in current[:2 * len(items) - 2]:
        for s in symbols:
            lengths[s] += 1
    return lengths


class Huffman:
    """A code from its weights as HUFv0x_readDTableX2 lays them out."""

    def __init__(self, data: bytes, limit: int = 11):
        counts: Dict[int, int] = {}
        for b in data:
            counts[b] = counts.get(b, 0) + 1
        lengths = code_lengths(counts, limit)
        top = max(lengths.values())
        self.log = top
        self.last = max(lengths)
        self.weights = [top + 1 - lengths[s] if s in lengths else 0
                        for s in range(self.last + 1)]
        rank = [0] * (top + 2)
        for w in self.weights:
            rank[w] += 1
        start, nxt = [0] * (top + 2), 0
        for w in range(1, top + 1):
            start[w] = nxt
            nxt += rank[w] << (w - 1)
        self.codes = {}
        for s, w in enumerate(self.weights):
            if w:
                self.codes[s] = (start[w] >> (w - 1), top + 1 - w)
                start[w] += 1 << (w - 1)

    def header(self, how: str = "auto", version: int = 7) -> bytes:
        """The weights of every symbol but the last: FSE-compressed, or 4
        bits each (how "raw"). v0.5's FSE decoder reads every symbol's
        update and ends with both states at 0; the later ones stop at the
        stream's end."""
        w = self.weights[:-1]
        if how in ("auto", "fse") and len(w) >= 2:
            counts: Dict[int, int] = {}
            for v in w:
                counts[v] = counts.get(v, 0) + 1
            if len(counts) >= 2:
                log = 5 if len(w) < 64 else 6
                norm = normalize(counts, log)
                table = Fse(norm, log)
                # two interleaved states: symbols 0, 2, 4... on the first
                s1 = w[0::2]
                s2 = w[1::2]
                final = 0 if version == 5 else None
                st1, up1 = table.walk(s1, final)
                st2, up2 = table.walk(s2, final) if s2 else (0, [])
                reads = [(st1, log), (st2, log)]
                for i in range(max(len(s1), len(s2))):
                    if i < len(up1):
                        reads.append(up1[i])
                    if i < len(up2):
                        reads.append(up2[i])
                body = write_ncount(norm, log) + bitstream(reads)
                if len(body) < 128 and how == "fse" or \
                        (how == "auto" and len(body) < (len(w) + 1) // 2):
                    return bytes([len(body)]) + body
                if how == "fse":
                    raise ValueError("the weights do not compress")
        if len(w) > 128:
            raise ValueError("too many weights for 4 bits each")
        padded = w + [0] * (len(w) & 1)
        return bytes([127 + len(w)]) + bytes(
            (padded[i] << 4) | padded[i + 1] for i in range(0, len(padded), 2))

    def stream(self, data: bytes) -> bytes:
        return bitstream([self.codes[b] for b in data])

    def streams4(self, data: bytes) -> bytes:
        seg = (len(data) + 3) // 4
        parts = [self.stream(data[i * seg:(i + 1) * seg]) for i in range(4)]
        if any(len(p) > 0xFFFF for p in parts[:3]):
            raise ValueError("a stream past 64 KiB")
        return struct.pack("<3H", *(len(p) for p in parts[:3])) + \
            b"".join(parts)


# -- literals sections ---------------------------------------------------------


def _size_header(kind: int, size: int) -> bytes:
    if size < 32:
        return bytes([(kind << 6) | size])
    if size < 4096:
        return bytes([(kind << 6) | (2 << 4) | (size >> 8), size & 255])
    return bytes([(kind << 6) | (3 << 4) | (size >> 16), (size >> 8) & 255,
                  size & 255])


def literals_raw(lits: bytes) -> bytes:
    return _size_header(2, len(lits)) + lits


def literals_rle(lits: bytes) -> bytes:
    assert len(set(lits)) <= 1
    return _size_header(3, len(lits)) + bytes([lits[0] if lits else 0])


def _huf_header(kind: int, code: int, size: int, csize: int) -> bytes:
    if code in (0, 1):
        assert size < 1024 and csize < 1024
        return bytes([(kind << 6) | (code << 4) | (size >> 6),
                      ((size & 63) << 2) | (csize >> 8), csize & 255])
    if code == 2:
        assert size < 1 << 14 and csize < 1 << 14
        return bytes([(kind << 6) | (2 << 4) | (size >> 10),
                      (size >> 2) & 255, ((size & 3) << 6) | (csize >> 8),
                      csize & 255])
    assert size < 1 << 18 and csize < 1 << 18
    return bytes([(kind << 6) | (3 << 4) | (size >> 14), (size >> 6) & 255,
                  ((size & 63) << 2) | (csize >> 16), (csize >> 8) & 255,
                  csize & 255])


def literals_huffman(lits: bytes, single: bool = False,
                     table: Optional[Huffman] = None,
                     weights: str = "auto",
                     version: int = 7) -> Tuple[bytes, Huffman]:
    """Huffman literals: one stream (a 3-byte header, under 1024 bytes) or
    four; table: v0.7's repeated table (no weights written)."""
    t = table or Huffman(lits)
    body = t.stream(lits) if single else t.streams4(lits)
    if table is not None:
        return _huf_header(1, 1, len(lits), len(body)) + body, t
    body = t.header(weights, version) + body
    if single:
        code = 1
    else:
        code = 0 if len(lits) < 1024 and len(body) < 1024 else \
            2 if len(lits) < 1 << 14 and len(body) < 1 << 14 else 3
    return _huf_header(0, code, len(lits), len(body)) + body, t


# -- sequences ---------------------------------------------------------------------

LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                      13, 14, 15, 16]
LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 0x80,
                             0x100, 0x200, 0x400, 0x800, 0x1000, 0x2000,
                             0x4000, 0x8000, 0x10000]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12,
                      13, 14, 15, 16]
ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,
                                0x83, 0x103, 0x203, 0x403, 0x803, 0x1003,
                                0x2003, 0x4003, 0x8003, 0x10003]
LL_NORM = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2,
           2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1]
ML_NORM = [1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7
OF_NORM = [1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5


def _code(value: int, base: Sequence[int], bits: Sequence[int]) -> int:
    for c in range(len(base) - 1, -1, -1):
        if base[c] <= value < base[c] + (1 << bits[c]):
            return c
    raise ValueError(f"no code for {value}")


class Rep:
    """A version's repeat offsets, as its decoder keeps them."""

    def __init__(self, version: int, reps=None):
        self.version = version
        self.prev = list(reps or [1, 4, 8]) if version == 7 else [1, 1, 1]
        self.last, self.prev5 = 1, 1        # v0.5

    def code(self, ll: int, offset: int, use_rep: bool = True):
        """(offset code, extra bits value, nbits) for offset, the state
        updated as the decoder updates it."""
        if self.version == 5:
            last, prev5 = self.last, self.prev5
            rep = last if ll else prev5
            if use_rep and offset == rep:
                out = (0, 0, 0)
            else:
                c = _highbit(offset) + 1
                out = (c, offset - (1 << (c - 1)), c - 1)
            if out[0] or not ll:
                self.prev5 = last
            self.last = offset
            return out
        p = self.prev
        if use_rep:
            # the value (0, 1, 2) whose repeat gives offset
            for value in (0, 1, 2):
                v = value
                if ll == 0 and v <= 1:
                    v = 1 - v
                got = p[v] if v else p[0]
                if got == offset:
                    if v:
                        temp = p[v]
                        if v != 1:
                            p[2] = p[1]
                        p[1] = p[0]
                        p[0] = temp
                    return (0, 0, 0) if value == 0 else (1, value - 1, 1)
        c = _highbit(offset + 3)
        p[2], p[1], p[0] = p[1], p[0], offset
        return c, offset + 3 - (1 << c), c


def sequences_section(version: int, seqs, rep: Rep, modes=("fse",) * 3,
                      previous=None, low: bool = False):
    """The sequences of a block: (bytes, the tables for a later block's
    repeat mode). seqs: (literal length, offset, match length, may use a
    repeat). modes, for LL, OF and ML: "predef" (v0.5: "raw"), "rle",
    "fse" or "repeat" (previous: the last block's tables)."""
    n = len(seqs)
    if version == 5:
        return _sequences5(seqs, rep, modes, low)
    if n == 0:
        return b"\x00", previous
    head = bytes([n]) if n < 128 else \
        bytes([0x80 + (n >> 8), n & 255]) if n < 0x7F00 else \
        bytes([0xFF]) + struct.pack("<H", n - 0x7F00)
    llc, mlc, ofc, extra = [], [], [], []
    for ll, off, ml, use in seqs:
        c, v, nb = rep.code(ll, off, use)
        ofc.append(c)
        l_c = _code(ll, LL_BASE, LL_BITS)
        m_c = _code(ml, ML_BASE, ML_BITS)
        llc.append(l_c)
        mlc.append(m_c)
        extra.append(((v, nb), (ml - ML_BASE[m_c], ML_BITS[m_c]),
                      (ll - LL_BASE[l_c], LL_BITS[l_c])))
    tables, desc, types = [], b"", 0
    for k, (codes, mode, norm, nlog, max_log) in enumerate((
            (llc, modes[0], LL_NORM, 6, 9), (ofc, modes[1], OF_NORM, 5, 8),
            (mlc, modes[2], ML_NORM, 6, 9))):
        if mode == "predef":
            tables.append(Fse(norm, nlog))
            t = 0
        elif mode == "rle":
            assert len(set(codes)) == 1
            tables.append(Fse.rle(codes[0]))
            desc += bytes([codes[0]])
            t = 1
        elif mode == "repeat":
            tables.append(previous[k])
            t = 2
        else:
            table, ncount = fse_table(codes, max_log, low)
            tables.append(table)
            desc += ncount
            t = 3
        types |= t << (6 - 2 * k)
    walks = [tables[0].walk(llc), tables[1].walk(ofc), tables[2].walk(mlc)]
    reads = [(walks[0][0], tables[0].log), (walks[1][0], tables[1].log),
             (walks[2][0], tables[2].log)]
    for i in range(n):
        of_extra, ml_extra, ll_extra = extra[i]
        reads += [of_extra, ml_extra, ll_extra]
        if i < n - 1:
            reads += [walks[0][1][i], walks[2][1][i], walks[1][1][i]]
    body = head + bytes([types]) + desc + bitstream(reads)
    return body, tables


def _sequences5(seqs, rep: Rep, modes, low: bool):
    n = len(seqs)
    if n == 0:
        return b"\x00", None
    assert n < 0x8000
    head = bytes([n]) if n < 128 else bytes([0x80 + (n >> 8), n & 255])
    llc, mlc, ofc, extra, dumps = [], [], [], [], bytearray()

    def dump(value: int) -> None:
        if value < 255:
            dumps.append(value)
        elif value < 1 << 15:
            dumps.append(255)
            dumps.extend(struct.pack("<H", value << 1))
        else:
            dumps.append(255)
            v = (value << 1) | 1
            dumps.extend(struct.pack("<H", v & 0xFFFF))
            dumps.append(v >> 16)

    for ll, off, ml, use in seqs:
        c, v, nb = rep.code(ll, off, use)
        ofc.append(c)
        extra.append((v, nb))
        if ll >= 63:
            llc.append(63)
            dump(ll - 63 if ll - 63 < 255 else ll)
        else:
            llc.append(ll)
        m = ml - 4
        if m >= 127:
            mlc.append(127)
            dump(m - 127 if m - 127 < 255 else m)
        else:
            mlc.append(m)
    tables, desc, types = [], b"", 0
    for k, (codes, mode, raw_bits, max_log) in enumerate((
            (llc, modes[0], 6, 10), (ofc, modes[1], 5, 9),
            (mlc, modes[2], 7, 10))):
        if mode == "raw":
            tables.append(Fse.raw(raw_bits))
            t = 0
        elif mode == "rle":
            assert len(set(codes)) == 1
            tables.append(Fse.rle(codes[0]))
            desc += bytes([codes[0]])
            t = 1
        elif mode == "repeat":
            tables.append(Fse.raw(raw_bits))
            t = 2
        else:
            table, ncount = fse_table(codes, max_log, low)
            tables.append(table)
            desc += ncount
            t = 3
        types |= t << (6 - 2 * k)
    dl = len(dumps)
    if dl < 512:
        types_bytes = bytes([types | (dl >> 8), dl & 255])
    else:
        types_bytes = bytes([types | 2, dl >> 8, dl & 255])
    walks = [tables[0].walk(llc), tables[1].walk(ofc), tables[2].walk(mlc)]
    reads = [(walks[0][0], tables[0].log), (walks[1][0], tables[1].log),
             (walks[2][0], tables[2].log)]
    for i in range(n):
        reads.append(extra[i])
        if i < n - 1:
            reads += [walks[1][1][i], walks[0][1][i], walks[2][1][i]]
    body = head + types_bytes + bytes(dumps) + desc + bitstream(reads)
    return body, tables


# -- an LZ77 parse -------------------------------------------------------------


def _match_length(data: bytes, j: int, i: int, limit: int) -> int:
    """How many bytes from data[i] on equal those from data[j] on (at
    least 4, which the key matched; at most limit), found by comparing
    slices, doubling, then halving."""
    n, step = 4, 16
    while n < limit:                      # whole steps that match
        m = min(step, limit - n)
        if data[j + n:j + n + m] != data[i + n:i + n + m]:
            break
        n += m
        step *= 2
    else:
        return limit if limit > 4 else 4
    lo, hi = n, n + min(step, limit - n)  # the first difference is below hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if data[j + lo:j + mid] == data[i + lo:i + mid]:
            lo = mid
        else:
            hi = mid
    return lo


def parse(data: bytes, start: int, end: int, min_match: int,
          window: int, max_match: int = 1 << 17,
          table: Optional[Dict[bytes, int]] = None):
    """Greedy matches of data[start:end] against data[:end] within window:
    (sequences (literal length, offset, match length), the trailing
    literals' start, the table). table: the last position of each 4-byte
    key below start (None: built from the window), which then holds those
    below end; the window check makes a key older than the window no
    match either way, so a table carried from block to block parses as a
    fresh one does."""
    seqs = []
    lit_start = start
    if table is None:
        table = {}
        i = max(0, start - window)
        while i < start:
            table[data[i:i + 4]] = i
            i += 1
    i = start
    get = table.get
    while i + 4 <= end:
        key = data[i:i + 4]
        j = get(key)
        table[key] = i
        if j is not None and i - j <= window:
            n = _match_length(data, j, i, min(end - i, max_match))
            if n >= min_match:
                seqs.append((i - lit_start, i - j, n))
                top = min(i + n, end - 3)
                table.update(zip([data[k:k + 4] for k in range(i + 1, top)],
                                 range(i + 1, top)))
                i += n
                lit_start = i
                continue
        i += 1
    for k in range(max(start, end - 3), end):     # the keys not yet read
        table[data[k:k + 4]] = k
    return seqs, lit_start, table


# -- blocks and frames -----------------------------------------------------------


def block_header(kind: int, size: int) -> bytes:
    assert size < 1 << 19
    return bytes([(kind << 6) | (size >> 16), (size >> 8) & 255, size & 255])


def raw_block(data: bytes) -> bytes:
    return block_header(1, len(data)) + data


def rle_block(byte: int, count: int) -> bytes:
    return block_header(2, count) + bytes([byte])


class Encoder:
    """Compressed blocks of one frame: each block's choice of literals
    mode and table modes, with the state the decoder keeps between blocks
    (repeat offsets, v0.7's Huffman table, the last sequence tables)."""

    def __init__(self, version: int, window: int = 1 << 17):
        self.version = version
        self.window = window
        self.huf: Optional[Huffman] = None
        self.tables = None
        self.reps = [1, 4, 8]
        self._lz = None      # (data, the end of the last block, its table)

    def block(self, data: bytes, start: int, end: int, lits: str = "auto",
              modes=None, use_rep: bool = True, low: bool = False,
              weights: str = "auto") -> bytes:
        """A compressed block of data[start:end] (data[:start]: what came
        before in the frame)."""
        v = self.version
        min_match = 4 if v == 5 else 3
        # the match table, carried on from the last block of the frame
        # (the keys of any raw block between added in order)
        carried = None
        if self._lz is not None and self._lz[0] is data and \
                self._lz[1] <= start:
            carried = self._lz[2]
            carried.update(zip([data[k:k + 4]
                                for k in range(self._lz[1], start)],
                               range(self._lz[1], start)))
        seqs, tail, table = parse(data, start, end, min_match, self.window,
                                  table=carried)
        self._lz = (data, end, table)
        literal = bytearray()
        at = start
        for ll, off, ml in seqs:
            literal += data[at:at + ll]
            at += ll + ml
        literal += data[tail:end]
        literal = bytes(literal)
        rep = Rep(v, self.reps)
        if modes is None:
            modes = ("raw" if v == 5 else "predef",) * 3 if len(seqs) < 8 \
                else ("fse",) * 3
        if modes == ("repeat",) * 3 and self.tables is None:
            modes = ("fse",) * 3
        body, tables = sequences_section(
            v, [(ll, off, ml, use_rep) for ll, off, ml in seqs], rep,
            modes, self.tables, low)
        if seqs:
            self.tables = tables
        if v == 7:
            self.reps = rep.prev
        lit = self._literals(literal, lits, weights)
        out = lit + body
        if len(out) >= BLOCK:
            raise ValueError("a compressed block of 128 KiB or more")
        return block_header(0, len(out)) + out

    def _literals(self, literal: bytes, lits: str, weights: str) -> bytes:
        auto = lits == "auto"
        if auto:
            lits = "rle" if len(set(literal)) <= 1 else \
                "raw" if len(literal) < 64 else "huf4"
        if lits == "raw":
            return literals_raw(literal)
        if lits == "rle":
            return literals_rle(literal)
        if lits == "repeat":
            section, _ = literals_huffman(literal, True, self.huf)
            return section
        try:
            section, t = literals_huffman(literal, lits == "huf1",
                                          weights=weights,
                                          version=self.version)
        except ValueError:
            if not auto:
                raise
            return literals_raw(literal)
        if auto and len(section) >= len(literal):
            return literals_raw(literal)
        self.huf = t
        return section


def frame_header(version: int, window_log: int = 17,
                 content_size: Optional[int] = None, checksum: bool = False,
                 single: bool = False, dict_id: int = 0,
                 window_mantissa: int = 0, reserved: int = 0,
                 fcs_code: Optional[int] = None) -> bytes:
    """The magic and the frame header of a version (v0.5: the window log
    alone; v0.6: window log and content size; v0.7: all its fields).
    reserved: bits set in the descriptor byte on top."""
    out = struct.pack("<I", MAGIC[version])
    if version == 5:
        return out + bytes([((window_log - 11) & 15) | reserved])
    if version == 6:
        cs = content_size
        code = fcs_code if fcs_code is not None else \
            0 if cs is None else 1 if cs < 256 else 2 if cs < 65792 else 3
        field = b"" if code == 0 else bytes([cs & 255]) if code == 1 else \
            struct.pack("<H", cs - 256) if code == 2 else \
            struct.pack("<Q", cs)
        return out + bytes([((window_log - 12) & 15) | (code << 6) |
                            reserved]) + field
    cs = content_size
    if fcs_code is not None:
        code = fcs_code
    elif cs is None:
        code = 0
    else:
        code = 0 if single and cs < 256 else 1 if 256 <= cs < 65792 else \
            2 if cs < 1 << 32 else 3
    did = 0 if not dict_id else 1 if dict_id < 256 else 2 if \
        dict_id < 65536 else 3
    fhd = did | (int(checksum) << 2) | (int(single) << 5) | (code << 6) | \
        reserved
    out += bytes([fhd])
    if not single:
        out += bytes([((window_log - 10) << 3) | window_mantissa])
    out += b"" if not did else dict_id.to_bytes((1, 2, 4)[did - 1], "little")
    if code == 0 and single:
        out += bytes([cs & 255])
    elif code == 1:
        out += struct.pack("<H", cs - 256)
    elif code == 2:
        out += struct.pack("<I", cs)
    elif code == 3:
        out += struct.pack("<Q", cs)
    return out


# -- XXH64 (v0.7's checksum: 22 bits of it in the end block) ------------------

_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5
_M = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M, 31) * _P1) & _M


def xxh64(data: bytes, seed: int = 0) -> int:
    n = len(data)
    i = 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M, (seed + _P2) & _M, seed,
             (seed - _P1) & _M]
        lanes = struct.unpack_from(f"<{(n // 32) * 4}Q", data)
        for k in range(0, len(lanes), 4):
            v = [_round(v[j], lanes[k + j]) for j in range(4)]
        i = (n // 32) * 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) +
             _rotl(v[3], 18)) & _M
        for j in range(4):
            h = ((h ^ _round(0, v[j])) * _P1 + _P4) & _M
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while i + 8 <= n:
        h ^= _round(0, struct.unpack_from("<Q", data, i)[0])
        h = (_rotl(h, 27) * _P1 + _P4) & _M
        i += 8
    if i + 4 <= n:
        h ^= (struct.unpack_from("<I", data, i)[0] * _P1) & _M
        h = (_rotl(h, 23) * _P2 + _P3) & _M
        i += 4
    while i < n:
        h ^= (data[i] * _P5) & _M
        h = (_rotl(h, 11) * _P1) & _M
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M
    h ^= h >> 29
    h = (h * _P3) & _M
    h ^= h >> 32
    return h


def end_block(version: int, content: Optional[bytes] = None) -> bytes:
    """The end block; v0.7 with content: its 22-bit checksum."""
    if content is None:
        return block_header(3, 0)
    h = (xxh64(content) >> 11) & ((1 << 22) - 1)
    return bytes([(3 << 6) | (h >> 16), (h >> 8) & 255, h & 255])


def frame(version: int, data: bytes, kinds: Sequence[str] = ("lz",),
          block_size: int = BLOCK - 1024, window_log: int = 17,
          checksum: bool = False, content_size: Optional[int] = None,
          single: bool = False, **block_kw) -> bytes:
    """A whole frame of data in blocks of block_size, each block's kind
    taken in turn from kinds ("raw", "rle", "lz")."""
    header = frame_header(version, window_log, content_size, checksum,
                          single)
    # v0.5's buffer is the window alone, restarted whenever a block no
    # longer fits: half of it is what a match can safely reach
    window = (content_size or len(data)) if version == 7 and single else \
        1 << (window_log - (version == 5))
    enc = Encoder(version, window)
    out = [header]
    k = 0
    for start in range(0, len(data), block_size):
        end = min(len(data), start + block_size)
        kind = kinds[k % len(kinds)]
        k += 1
        if kind == "raw":
            out.append(raw_block(data[start:end]))
        elif kind == "rle":
            assert len(set(data[start:end])) == 1
            out.append(rle_block(data[start], end - start))
        else:
            out.append(enc.block(data, start, end, **block_kw))
    out.append(end_block(version, data if version == 7 and checksum
                         else None))
    return b"".join(out)


if __name__ == "__main__":
    from tests import torch_tiff_zstd_lzma_corpus as zc
    payload = bytes(range(40)) * 30
    for v in (5, 6, 7):
        f = frame(v, payload)
        print(v, len(f), zc.zstd_libtiff(f, len(payload))[0])
