// libtiff 4.7.1's CCITT fax decoders (tif_fax3.c, tif_fax3.h) as
// TIFFReadEncodedStrip and TIFFReadEncodedTile drive them for Pillow
// 12.1.0's TiffDecode.c: Fax3DecodeRLE for Compression 2 (RLE) and 32771
// (RLEW), Fax3Decode1D and Fax3Decode2D for 3 (Group 3, by T4Options bit
// 0), Fax4Decode for 4 (Group 4), each chunk's runs filled into rows by
// _TIFFFax3fillruns (black runs as 1 bits).
//
// The state tables are libtiff's (tif_fax3sm.c, made by mkg3states.c),
// built here from the T.4 and T.6 code words: a table entry is indexed by
// the next 7 (modes), 12 (white runs) or 13 (black runs) bits of input,
// first bit lowest, and holds the code's state, width and parameter.
// Input bits are reversed through a table unless the fill order is 2
// (the codec sets TIFF_NOBITREV, so libtiff hands it the file's bytes as
// they are, in place in the mapped file: RLEW's word alignment follows
// the address, so the chunk's file offset).
//
// The decoders are libtiff's macros as they are, with their errors:
// a premature end of data fails Fax3DecodeRLE, Fax3Decode1D and
// Fax3Decode2D (and so Pillow's read), and Fax4Decode only before its
// first row; a bad code word, a row of the wrong length and the
// uncompressed-mode extension are messages, and the row is cleaned up
// (CLEANUP_RUNS) and the decode goes on.
//
// fax_tiff_chunks(file, offsets, counts, occs, n, out, cap, compression,
//                 t4options, fillorder, rowpixels, rowbytes, status):
// the n chunks (strips or tiles) of one image decoded in turn, each into
// libtiff's one buffer of occs[k] bytes (Pillow's, reused: what a chunk
// leaves unwritten keeps the previous chunk's bytes, and at first the
// byte fill, where Pillow's buffer holds whatever its memory held),
// copied to out + k * cap; status[k] is 1 where libtiff's read fails
// (setup; a strip whose decoder returns -1: a tile's never fails), else
// 0. The codec's
// state that libtiff keeps from chunk to chunk (its mode, the run
// arrays) is kept here too.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum {
    S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
    S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL
};

struct TabEnt {
    uint8_t state;
    uint8_t width;
    uint32_t param;
};

TabEnt main_table[128];
TabEnt white_table[4096];
TabEnt black_table[8192];
uint8_t bit_rev[256];
uint8_t no_bit_rev[256];

struct Code {
    const char *bits;   // the code word, first bit first
    uint32_t param;
};

// T.4's terminating codes (runs 0-63)
const char *const kWhiteTerm[64] = {
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
    "00110100"};
const char *const kBlackTerm[64] = {
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
    "000001100111"};
// make-up codes of runs 64, 128, ..., 1728
const char *const kWhiteMakeUp[27] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111",
    "01100100", "01100101", "01101000", "01100111", "011001100",
    "011001101", "011010010", "011010011", "011010100", "011010101",
    "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000",
    "010011011"};
const char *const kBlackMakeUp[27] = {
    "0000001111", "000011001000", "000011001001", "000001011011",
    "000000110011", "000000110100", "000000110101", "0000001101100",
    "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101"};
// the extended make-up codes both colours share (runs 1792-2560)
const char *const kMakeUp[13] = {
    "00000001000", "00000001100", "00000001101", "000000010010",
    "000000010011", "000000010100", "000000010101", "000000010110",
    "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111"};

// mkg3states' FillTable: every index whose low bits are the code word,
// first bit lowest
void fill_table(TabEnt *table, int size, const Code *codes, int n,
                int state) {
    for (int i = 0; i < n; i++) {
        const int width = (int)strlen(codes[i].bits);
        uint32_t code = 0;
        for (int b = 0; b < width; b++)
            code |= (uint32_t)(codes[i].bits[b] - '0') << b;
        for (uint32_t at = code; at < (1u << size); at += 1u << width)
            table[at] = {(uint8_t)state, (uint8_t)width, codes[i].param};
    }
}

void fill_runs(TabEnt *table, int size, const char *const *bits, int n,
               uint32_t first, uint32_t step, int state) {
    std::vector<Code> codes;
    for (int i = 0; i < n; i++) codes.push_back({bits[i], first + i * step});
    fill_table(table, size, codes.data(), n, state);
}

struct Tables {
    Tables() {
        const Code pass[] = {{"0001", 0}};
        const Code horiz[] = {{"001", 0}};
        const Code v0[] = {{"1", 0}};
        const Code vr[] = {{"011", 1}, {"000011", 2}, {"0000011", 3}};
        const Code vl[] = {{"010", 1}, {"000010", 2}, {"0000010", 3}};
        const Code ext[] = {{"0000001", 0}};
        const Code eolv[] = {{"0000000", 0}};
        const Code eolh[] = {{"00000000000", 0}};
        fill_table(main_table, 7, pass, 1, S_Pass);
        fill_table(main_table, 7, horiz, 1, S_Horiz);
        fill_table(main_table, 7, v0, 1, S_V0);
        fill_table(main_table, 7, vr, 3, S_VR);
        fill_table(main_table, 7, vl, 3, S_VL);
        fill_table(main_table, 7, ext, 1, S_Ext);
        fill_table(main_table, 7, eolv, 1, S_EOL);
        fill_runs(white_table, 12, kWhiteMakeUp, 27, 64, 64, S_MakeUpW);
        fill_runs(white_table, 12, kMakeUp, 13, 1792, 64, S_MakeUp);
        fill_runs(white_table, 12, kWhiteTerm, 64, 0, 1, S_TermW);
        fill_table(white_table, 12, eolh, 1, S_EOL);
        fill_runs(black_table, 13, kBlackMakeUp, 27, 64, 64, S_MakeUpB);
        fill_runs(black_table, 13, kMakeUp, 13, 1792, 64, S_MakeUp);
        fill_runs(black_table, 13, kBlackTerm, 64, 0, 1, S_TermB);
        fill_table(black_table, 13, eolh, 1, S_EOL);
        for (int i = 0; i < 256; i++) {
            int r = 0;
            for (int b = 0; b < 8; b++) r |= ((i >> b) & 1) << (7 - b);
            bit_rev[i] = (uint8_t)r;
            no_bit_rev[i] = (uint8_t)i;
        }
    }
};
const Tables tables;

// libtiff's FAXMODE_ bits
constexpr int FAXMODE_NOEOL = 0x2;
constexpr int FAXMODE_BYTEALIGN = 0x4;
constexpr int FAXMODE_WORDALIGN = 0x8;

// _TIFFFax3fillruns: white runs clear bits, black runs set them; bits
// past lastx are left as they are
void fill_runs_row(uint8_t *buf, uint32_t *runs, uint32_t *erun,
                   uint32_t lastx) {
    static const uint8_t fillmasks[] = {0x00, 0x80, 0xc0, 0xe0, 0xf0,
                                        0xf8, 0xfc, 0xfe, 0xff};
    if ((erun - runs) & 1) *erun++ = 0;
    uint32_t x = 0;
    for (; runs < erun; runs += 2) {
        uint32_t run = runs[0];
        if (x + run > lastx || run > lastx) run = runs[0] = lastx - x;
        if (run) {
            uint8_t *cp = buf + (x >> 3);
            uint32_t bx = x & 7;
            if (run > 8 - bx) {
                if (bx) {
                    *cp++ &= (uint8_t)(0xff << (8 - bx));
                    run -= 8 - bx;
                }
                uint32_t n = run >> 3;
                if (n) {
                    memset(cp, 0, n);
                    cp += n;
                    run &= 7;
                }
                if (run) cp[0] &= (uint8_t)(0xff >> run);
            } else {
                cp[0] &= (uint8_t)~(fillmasks[run] >> bx);
            }
            x += runs[0];
        }
        run = runs[1];
        if (x + run > lastx || run > lastx) run = runs[1] = lastx - x;
        if (run) {
            uint8_t *cp = buf + (x >> 3);
            uint32_t bx = x & 7;
            if (run > 8 - bx) {
                if (bx) {
                    *cp++ |= (uint8_t)(0xff >> bx);
                    run -= 8 - bx;
                }
                uint32_t n = run >> 3;
                if (n) {
                    memset(cp, 0xff, n);
                    cp += n;
                    run &= 7;
                }
                if (run) cp[0] = (uint8_t)((cp[0] | (0xff00 >> run)) & 0xff);
            } else {
                cp[0] |= (uint8_t)(fillmasks[run] >> bx);
            }
            x += runs[1];
        }
    }
}

// The codec's state for one image (Fax3CodecState, decoder half).
struct Fax {
    int mode = 0;
    bool two_d = false;       // Fax3Decode2D or Fax4Decode
    int compression = 0;
    const uint8_t *bitmap = nullptr;
    uint32_t rowpixels = 0;
    int64_t rowbytes = 0;
    uint32_t nruns = 0;
    std::vector<uint32_t> runs;
    uint32_t *curruns = nullptr;
    uint32_t *refruns = nullptr;
    uint32_t line = 0;
    // the chunk
    const uint8_t *cp0 = nullptr;  // the chunk's first byte
    int64_t offset = 0;            // its file offset (the address parity)
    const uint8_t *cp = nullptr;
    const uint8_t *ep = nullptr;
    uint32_t data = 0;
    int bit = 0;
    int eolcnt = 0;

    bool setup(int comp, int t4options, int fillorder, uint32_t pixels,
               int64_t bytes) {
        compression = comp;
        rowpixels = pixels;
        rowbytes = bytes;
        if (rowbytes < ((int64_t)rowpixels + 7) / 8) return false;
        mode = comp == 2 ? (0x1 | FAXMODE_NOEOL | FAXMODE_BYTEALIGN)
             : comp == 32771 ? (0x1 | FAXMODE_NOEOL | FAXMODE_WORDALIGN)
             : 0x1;
        two_d = comp == 4 || (comp == 3 && (t4options & 1));
        const uint64_t rounded = ((uint64_t)rowpixels + 1 + 31) / 32 * 32;
        uint64_t n = rounded;
        if (two_d) n *= 2;
        if (n == 0 || n > 0xffffffffull || 2 * n > 0xffffffffull ||
            n > (1ull << 31))
            return false;
        nruns = (uint32_t)n;
        runs.assign(2 * (size_t)nruns, 0);
        bitmap = fillorder != 2 ? bit_rev : no_bit_rev;
        return true;
    }

    void predecode(const uint8_t *chunk, int64_t count, int64_t off) {
        bit = 0;
        data = 0;
        eolcnt = 0;
        curruns = runs.data();
        refruns = nullptr;
        if (two_d) {
            refruns = runs.data() + nruns;
            refruns[0] = rowpixels;
            refruns[1] = 0;
        }
        line = 0;
        cp0 = cp = chunk;
        ep = chunk + count;
        offset = off;
    }

    bool aligned16(const uint8_t *p) const {
        return ((offset + (p - cp0)) & 1) == 0;
    }

    int decode(uint8_t *buf, int64_t occ);
    int decode_rle(uint8_t *buf, int64_t occ);
    int decode_1d(uint8_t *buf, int64_t occ);
    int decode_2d(uint8_t *buf, int64_t occ);
    int decode_g4(uint8_t *buf, int64_t occ);
};

// ---- tif_fax3.h's macros, over the locals each decoder declares ----------

#define EndOfData() (cp >= ep)

#define NeedBits8(n, eoflab)                                                 \
    do {                                                                     \
        if (BitsAvail < (n)) {                                               \
            if (EndOfData()) {                                               \
                if (BitsAvail == 0) goto eoflab;                             \
                BitsAvail = (n);                                             \
            } else {                                                         \
                BitAcc |= ((uint32_t)bitmap[*cp++]) << BitsAvail;            \
                BitsAvail += 8;                                              \
            }                                                                \
        }                                                                    \
    } while (0)

#define NeedBits16(n, eoflab)                                                \
    do {                                                                     \
        if (BitsAvail < (n)) {                                               \
            if (EndOfData()) {                                               \
                if (BitsAvail == 0) goto eoflab;                             \
                BitsAvail = (n);                                             \
            } else {                                                         \
                BitAcc |= ((uint32_t)bitmap[*cp++]) << BitsAvail;            \
                if ((BitsAvail += 8) < (n)) {                                \
                    if (EndOfData()) {                                       \
                        BitsAvail = (n);                                     \
                    } else {                                                 \
                        BitAcc |= ((uint32_t)bitmap[*cp++]) << BitsAvail;    \
                        BitsAvail += 8;                                      \
                    }                                                        \
                }                                                            \
            }                                                                \
        }                                                                    \
    } while (0)

#define GetBits(n) (BitAcc & ((1u << (n)) - 1))
#define ClrBits(n)                                                           \
    do {                                                                     \
        BitsAvail -= (n);                                                    \
        BitAcc >>= (n);                                                      \
    } while (0)

#define LOOKUP8(wid, tab, eoflab)                                            \
    do {                                                                     \
        NeedBits8(wid, eoflab);                                              \
        TabEnt = tab + GetBits(wid);                                         \
        ClrBits(TabEnt->width);                                              \
    } while (0)
#define LOOKUP16(wid, tab, eoflab)                                           \
    do {                                                                     \
        NeedBits16(wid, eoflab);                                             \
        TabEnt = tab + GetBits(wid);                                         \
        ClrBits(TabEnt->width);                                              \
    } while (0)

// a run past the run array fails the decode ("Buffer overflow")
#define SETVALUE(x)                                                          \
    do {                                                                     \
        if (pa >= thisrun + nruns) return -1;                                \
        *pa++ = RunLength + (x);                                             \
        a0 += (x);                                                           \
        RunLength = 0;                                                       \
    } while (0)

// Fax3Unexpected, Fax3Extension, Fax3BadLength and Fax3PrematureEOF are
// messages alone
#define unexpected(table, a0) ((void)0)
#define extension(a0) ((void)0)
#define badlength(a0, lastx) ((void)0)
#define prematureEOF(a0) ((void)0)

// The EOL before a row, skipped with the zero bits before it. Where no
// bit is left as the search for its 11 zeros starts, the decode fails
// (eoflab). Where the data end after that, before the EOL's 1 bit (the
// zero bits padded past the end read as its zeros), the decoder takes the
// data for Group 3 without EOLs (FAXMODE_NOEOL, kept for every later row
// and chunk of the image: "Try to decode (read) fax Group 3 data without
// EOL") and starts over from the chunk's first bit, at the row it had
// reached.
#define SYNC_EOL(eoflab, retrywithouteol)                                    \
    do {                                                                     \
        if (!(mode & FAXMODE_NOEOL)) {                                       \
            if (EOLcnt == 0) {                                               \
                for (;;) {                                                   \
                    NeedBits16(11, eoflab);                                  \
                    if (GetBits(11) == 0) break;                             \
                    ClrBits(1);                                              \
                }                                                            \
            }                                                                \
            for (;;) {                                                       \
                NeedBits8(8, noEOLFound);                                    \
                if (GetBits(8)) break;                                       \
                ClrBits(8);                                                  \
            }                                                                \
            while (GetBits(1) == 0) ClrBits(1);                              \
            ClrBits(1);                                                      \
            EOLcnt = 0;                                                      \
            break;                                                           \
        noEOLFound:                                                          \
            mode |= FAXMODE_NOEOL;                                           \
            goto retrywithouteol;                                            \
        }                                                                    \
    } while (0)

#define CLEANUP_RUNS()                                                       \
    do {                                                                     \
        if (RunLength) SETVALUE(0);                                          \
        if (a0 != lastx) {                                                   \
            badlength(a0, lastx);                                            \
            while (a0 > lastx && pa > thisrun) a0 -= *--pa;                  \
            if (a0 < lastx) {                                                \
                if (a0 < 0) a0 = 0;                                          \
                if ((pa - thisrun) & 1) SETVALUE(0);                         \
                SETVALUE(lastx - a0);                                        \
            } else if (a0 > lastx) {                                         \
                SETVALUE(lastx);                                             \
                SETVALUE(0);                                                 \
            }                                                                \
        }                                                                    \
    } while (0)

#define EXPAND1D(eoflab)                                                     \
    do {                                                                     \
        for (;;) {                                                           \
            for (;;) {                                                       \
                LOOKUP16(12, white_table, eof1d);                            \
                switch (TabEnt->state) {                                     \
                case S_EOL:                                                  \
                    EOLcnt = 1;                                              \
                    goto done1d;                                             \
                case S_TermW:                                                \
                    SETVALUE(TabEnt->param);                                 \
                    goto doneWhite1d;                                        \
                case S_MakeUpW:                                              \
                case S_MakeUp:                                               \
                    a0 += TabEnt->param;                                     \
                    RunLength += TabEnt->param;                              \
                    break;                                                   \
                default:                                                     \
                    unexpected("WhiteTable", a0);                            \
                    goto done1d;                                             \
                }                                                            \
            }                                                                \
        doneWhite1d:                                                         \
            if (a0 >= lastx) goto done1d;                                    \
            for (;;) {                                                       \
                LOOKUP16(13, black_table, eof1d);                            \
                switch (TabEnt->state) {                                     \
                case S_EOL:                                                  \
                    EOLcnt = 1;                                              \
                    goto done1d;                                             \
                case S_TermB:                                                \
                    SETVALUE(TabEnt->param);                                 \
                    goto doneBlack1d;                                        \
                case S_MakeUpB:                                              \
                case S_MakeUp:                                               \
                    a0 += TabEnt->param;                                     \
                    RunLength += TabEnt->param;                              \
                    break;                                                   \
                default:                                                     \
                    unexpected("BlackTable", a0);                            \
                    goto done1d;                                             \
                }                                                            \
            }                                                                \
        doneBlack1d:                                                         \
            if (a0 >= lastx) goto done1d;                                    \
            if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;                   \
        }                                                                    \
    eof1d:                                                                   \
        prematureEOF(a0);                                                    \
        CLEANUP_RUNS();                                                      \
        goto eoflab;                                                         \
    done1d:                                                                  \
        CLEANUP_RUNS();                                                      \
    } while (0)

// the reference line's next change past a0 (a run array past its end
// fails the decode)
#define CHECK_b1                                                             \
    do {                                                                     \
        if (pa != thisrun)                                                   \
            while (b1 <= a0 && b1 < lastx) {                                 \
                if (pb + 1 >= refruns + nruns) return -1;                    \
                b1 += pb[0] + pb[1];                                         \
                pb += 2;                                                     \
            }                                                                \
    } while (0)

#define EXPAND2D(eoflab)                                                     \
    do {                                                                     \
        while (a0 < lastx) {                                                 \
            if (pa >= thisrun + nruns) return -1;                            \
            LOOKUP8(7, main_table, eof2d);                                   \
            switch (TabEnt->state) {                                         \
            case S_Pass:                                                     \
                CHECK_b1;                                                    \
                if (pb + 1 >= refruns + nruns) return -1;                    \
                b1 += *pb++;                                                 \
                RunLength += b1 - a0;                                        \
                a0 = b1;                                                     \
                b1 += *pb++;                                                 \
                break;                                                       \
            case S_Horiz:                                                    \
                if ((pa - thisrun) & 1) {                                    \
                    for (;;) {                                               \
                        LOOKUP16(13, black_table, eof2d);                    \
                        switch (TabEnt->state) {                             \
                        case S_TermB:                                        \
                            SETVALUE(TabEnt->param);                         \
                            goto doneWhite2da;                               \
                        case S_MakeUpB:                                      \
                        case S_MakeUp:                                       \
                            a0 += TabEnt->param;                             \
                            RunLength += TabEnt->param;                      \
                            break;                                           \
                        default:                                             \
                            goto badBlack2d;                                 \
                        }                                                    \
                    }                                                        \
                doneWhite2da:;                                               \
                    for (;;) {                                               \
                        LOOKUP16(12, white_table, eof2d);                    \
                        switch (TabEnt->state) {                             \
                        case S_TermW:                                        \
                            SETVALUE(TabEnt->param);                         \
                            goto doneBlack2da;                               \
                        case S_MakeUpW:                                      \
                        case S_MakeUp:                                       \
                            a0 += TabEnt->param;                             \
                            RunLength += TabEnt->param;                      \
                            break;                                           \
                        default:                                             \
                            goto badWhite2d;                                 \
                        }                                                    \
                    }                                                        \
                doneBlack2da:;                                               \
                } else {                                                     \
                    for (;;) {                                               \
                        LOOKUP16(12, white_table, eof2d);                    \
                        switch (TabEnt->state) {                             \
                        case S_TermW:                                        \
                            SETVALUE(TabEnt->param);                         \
                            goto doneWhite2db;                               \
                        case S_MakeUpW:                                      \
                        case S_MakeUp:                                       \
                            a0 += TabEnt->param;                             \
                            RunLength += TabEnt->param;                      \
                            break;                                           \
                        default:                                             \
                            goto badWhite2d;                                 \
                        }                                                    \
                    }                                                        \
                doneWhite2db:;                                               \
                    for (;;) {                                               \
                        LOOKUP16(13, black_table, eof2d);                    \
                        switch (TabEnt->state) {                             \
                        case S_TermB:                                        \
                            SETVALUE(TabEnt->param);                         \
                            goto doneBlack2db;                               \
                        case S_MakeUpB:                                      \
                        case S_MakeUp:                                       \
                            a0 += TabEnt->param;                             \
                            RunLength += TabEnt->param;                      \
                            break;                                           \
                        default:                                             \
                            goto badBlack2d;                                 \
                        }                                                    \
                    }                                                        \
                doneBlack2db:;                                               \
                }                                                            \
                CHECK_b1;                                                    \
                break;                                                       \
            case S_V0:                                                       \
                CHECK_b1;                                                    \
                SETVALUE(b1 - a0);                                           \
                b1 += *pb++;                                                 \
                break;                                                       \
            case S_VR:                                                       \
                CHECK_b1;                                                    \
                SETVALUE(b1 - a0 + (int)TabEnt->param);                      \
                b1 += *pb++;                                                 \
                break;                                                       \
            case S_VL:                                                       \
                CHECK_b1;                                                    \
                if (b1 < (int)(a0 + TabEnt->param)) {                        \
                    unexpected("VL", a0);                                    \
                    goto eol2d;                                              \
                }                                                            \
                SETVALUE(b1 - a0 - (int)TabEnt->param);                      \
                /* libtiff reads before the run array here, the port 0 */   \
                b1 -= pb > runs.data() ? *--pb : 0;                          \
                break;                                                       \
            case S_Ext:                                                      \
                *pa++ = lastx - a0;                                          \
                extension(a0);                                               \
                goto eol2d;                                                  \
            case S_EOL:                                                      \
                *pa++ = lastx - a0;                                          \
                NeedBits8(4, eof2d);                                         \
                if (GetBits(4)) unexpected("EOL", a0);                       \
                ClrBits(4);                                                  \
                EOLcnt = 1;                                                  \
                goto eol2d;                                                  \
            default:                                                         \
            badMain2d:                                                       \
                unexpected("MainTable", a0);                                 \
                goto eol2d;                                                  \
            badBlack2d:                                                      \
                unexpected("BlackTable", a0);                                \
                goto eol2d;                                                  \
            badWhite2d:                                                      \
                unexpected("WhiteTable", a0);                                \
                goto eol2d;                                                  \
            eof2d:                                                           \
                prematureEOF(a0);                                            \
                CLEANUP_RUNS();                                              \
                goto eoflab;                                                 \
            }                                                                \
        }                                                                    \
        if (RunLength) {                                                     \
            if (RunLength + a0 < lastx) {                                    \
                NeedBits8(1, eof2d);                                         \
                if (!GetBits(1)) goto badMain2d;                             \
                ClrBits(1);                                                  \
            }                                                                \
            SETVALUE(0);                                                     \
        }                                                                    \
    eol2d:                                                                   \
        CLEANUP_RUNS();                                                      \
    } while (0)

#define DECLARE_STATE                                                        \
    int a0 = 0;                                                              \
    const int lastx = (int)rowpixels;                                        \
    uint32_t BitAcc = data;                                                  \
    int BitsAvail = bit;                                                     \
    int RunLength = 0;                                                       \
    uint32_t *pa = nullptr;                                                  \
    uint32_t *thisrun = curruns;                                             \
    int EOLcnt = eolcnt;                                                     \
    const uint8_t *const cp_call = cp;                                       \
    const TabEnt *TabEnt = nullptr;                                          \
    (void)TabEnt;                                                            \
    (void)cp_call

// CACHE_STATE: the bit reader as the call found it
#define CACHE_STATE                                                          \
    do {                                                                     \
        BitAcc = data;                                                       \
        BitsAvail = bit;                                                     \
        EOLcnt = eolcnt;                                                     \
        cp = cp_call;                                                        \
    } while (0)

#define UNCACHE_STATE                                                        \
    do {                                                                     \
        bit = BitsAvail;                                                     \
        data = BitAcc;                                                       \
        eolcnt = EOLcnt;                                                     \
    } while (0)

int Fax::decode_rle(uint8_t *buf, int64_t occ) {
    DECLARE_STATE;
    if (occ % rowbytes) return -1;
    while (occ > 0) {
        a0 = 0;
        RunLength = 0;
        pa = thisrun;
        EXPAND1D(EOFRLE);
        fill_runs_row(buf, thisrun, pa, lastx);
        if (mode & FAXMODE_BYTEALIGN) {
            int n = BitsAvail - (BitsAvail & ~7);
            ClrBits(n);
        } else if (mode & FAXMODE_WORDALIGN) {
            int n = BitsAvail - (BitsAvail & ~15);
            ClrBits(n);
            if (BitsAvail == 0 && !aligned16(cp)) cp++;
        }
        buf += rowbytes;
        occ -= rowbytes;
        line++;
        continue;
    EOFRLE:
        fill_runs_row(buf, thisrun, pa, lastx);
        UNCACHE_STATE;
        return -1;
    }
    UNCACHE_STATE;
    return 1;
}

int Fax::decode_1d(uint8_t *buf, int64_t occ) {
    DECLARE_STATE;
    if (occ % rowbytes) return -1;
RETRY_WITHOUT_EOL_1D:
    CACHE_STATE;
    thisrun = curruns;
    while (occ > 0) {
        a0 = 0;
        RunLength = 0;
        pa = thisrun;
        SYNC_EOL(EOF1D, RETRY_WITHOUT_EOL_1D);
        EXPAND1D(EOF1Da);
        fill_runs_row(buf, thisrun, pa, lastx);
        buf += rowbytes;
        occ -= rowbytes;
        line++;
        continue;
    EOF1D:
        CLEANUP_RUNS();
    EOF1Da:
        fill_runs_row(buf, thisrun, pa, lastx);
        UNCACHE_STATE;
        return -1;
    }
    UNCACHE_STATE;
    return 1;
}

int Fax::decode_2d(uint8_t *buf, int64_t occ) {
    DECLARE_STATE;
    int b1 = 0;
    uint32_t *pb = nullptr;
    if (occ % rowbytes) return -1;
RETRY_WITHOUT_EOL_2D:
    CACHE_STATE;
    while (occ > 0) {
        a0 = 0;
        RunLength = 0;
        pa = thisrun = curruns;
        SYNC_EOL(EOF2D, RETRY_WITHOUT_EOL_2D);
        {
            NeedBits8(1, EOF2D);
            const int is1D = (int)GetBits(1);
            ClrBits(1);
            pb = refruns;
            b1 = (int)*pb++;
            if (is1D)
                EXPAND1D(EOF2Da);
            else
                EXPAND2D(EOF2Da);
        }
        fill_runs_row(buf, thisrun, pa, lastx);
        if (pa < thisrun + nruns) SETVALUE(0);
        {
            uint32_t *t = curruns;
            curruns = refruns;
            refruns = t;
        }
        buf += rowbytes;
        occ -= rowbytes;
        line++;
        continue;
    EOF2D:
        CLEANUP_RUNS();
    EOF2Da:
        fill_runs_row(buf, thisrun, pa, lastx);
        UNCACHE_STATE;
        return -1;
    }
    UNCACHE_STATE;
    return 1;
}

int Fax::decode_g4(uint8_t *buf, int64_t occ) {
    DECLARE_STATE;
    int b1 = 0;
    uint32_t *pb = nullptr;
    if (occ % rowbytes) return -1;
    const uint32_t start = line;
    while (occ > 0) {
        a0 = 0;
        RunLength = 0;
        pa = thisrun = curruns;
        pb = refruns;
        b1 = (int)*pb++;
        EXPAND2D(EOFG4);
        if (EOLcnt) goto EOFG4;
        if (((lastx + 7) >> 3) > (int)occ) return -1;
        fill_runs_row(buf, thisrun, pa, lastx);
        SETVALUE(0);
        {
            uint32_t *t = curruns;
            curruns = refruns;
            refruns = t;
        }
        buf += rowbytes;
        occ -= rowbytes;
        line++;
        continue;
    EOFG4:
        NeedBits16(13, BADG4);
    BADG4:
        ClrBits(13);
        if (((lastx + 7) >> 3) > (int)occ) return -1;
        fill_runs_row(buf, thisrun, pa, lastx);
        UNCACHE_STATE;
        return line != start ? 1 : -1;
    }
    UNCACHE_STATE;
    return 1;
}

int Fax::decode(uint8_t *buf, int64_t occ) {
    if (compression == 2 || compression == 32771) return decode_rle(buf, occ);
    if (compression == 4) return decode_g4(buf, occ);
    return two_d ? decode_2d(buf, occ) : decode_1d(buf, occ);
}

}  // namespace

extern "C" void fax_tiff_chunks(const uint8_t *file, const int64_t *offsets,
                                const int64_t *counts, const int64_t *occs,
                                int64_t n, uint8_t *out, int64_t cap,
                                int compression, int t4options, int fillorder,
                                int64_t rowpixels, int64_t rowbytes, int bps,
                                int spp, int planar, int tiled, int fill,
                                int32_t *status) {
    for (int64_t k = 0; k < n; k++) status[k] = 1;
    // Fax3SetupState's checks
    if (bps != 1 || (spp != 1 && planar == 1) || rowpixels < 0 ||
        rowpixels > 0xffffffffll || rowbytes <= 0)
        return;
    Fax fax;
    if (!fax.setup(compression, t4options, fillorder, (uint32_t)rowpixels,
                   rowbytes))
        return;
    std::vector<uint8_t> buf((size_t)cap, (uint8_t)fill);
    for (int64_t k = 0; k < n; k++) {
        fax.predecode(file + offsets[k], counts[k], offsets[k]);
        const int64_t occ = occs[k] < cap ? occs[k] : cap;
        // TIFFReadEncodedStrip fails a decode that returns 0 or -1;
        // TIFFReadEncodedTile only one that returns 0, which these
        // decoders never do
        const int ret = fax.decode(buf.data(), occ);
        status[k] = (tiled ? ret != 0 : ret > 0) ? 0 : 1;
        memcpy(out + k * cap, buf.data(), (size_t)cap);
    }
}
