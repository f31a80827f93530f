// JPEG 2000 (ISO/IEC 15444-1) as Pillow 12.1.0's Jpeg2KDecode.c reads it
// over OpenJPEG 2.5.4: opj_read_header, then opj_read_tile_header and
// opj_decode_tile_data tile by tile (so OpenJPEG's JP2 colour handling of
// pclr, cmap, cdef never runs: only its colour space from colr), then
// opj_end_decompress; each tile's buffer unpacked into Pillow's image by
// Pillow's unpackers. Every failure of those calls fails Pillow's load.
//
// The decoder follows OpenJPEG's decode path in order: the JP2 boxes
// (jp2.c), the codestream's main header and tile-part headers with their
// checks in OpenJPEG's default strict mode (j2k.c), the tile, its
// resolutions, bands, precincts and code-blocks (tcd.c), the progression
// iterator with POC (pi.c), the packet headers with their tag trees, SOP
// and EPH, packed headers from PPM and PPT (t2.c, tgt.c, bio.c), the MQ
// decoder and the three coding passes with every code-block style of
// Part 1 (t1.c, mqc.c), the reversible and irreversible dequantisation
// and the RGN shift, the 5/3 and 9/7 inverse DWT as OpenJPEG evaluates
// them (dwt.c: its lifting constants, its order of operations, its
// two_invK), the inverse RCT and ICT (mct.c), the DC level shift and
// clamp, and opj_tcd_update_tile_data's packing of a tile's components.
//
// Floating point: the 9/7 lifting, the dequantisation and the ICT are
// float operations in OpenJPEG's order, never contracted into FMAs (the
// pragma below: the shared compile line uses -march=native, and the
// library in Pillow's wheel has no FMA), and lrintf rounds to even.
//
// j2k_decode(file, n, codec, mode, width, height, out): codec 0 for a
// codestream, 2 for a JP2 file; mode and the size are Pillow's open's
// (data/jpeg2k.py); out holds Pillow's image, zeroed by the caller
// (1 byte a pixel for L and P, 2 for I;16, 4 for the others). Returns 0
// where Pillow's load succeeds, else 1.

#pragma GCC optimize("fp-contract=off")

#include <cmath>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

typedef uint32_t u32;
typedef int32_t i32;
typedef int64_t i64;
typedef uint64_t u64;

// Pillow's modes, as data/jpeg2k.py numbers them
enum Mode { M_L, M_I16, M_LA, M_RGB, M_RGBA, M_CMYK, M_P, M_PA };

// OPJ_COLOR_SPACE
enum { CS_UNKNOWN = -1, CS_UNSPECIFIED = 0, CS_SRGB, CS_GRAY, CS_SYCC,
       CS_EYCC, CS_CMYK };

inline i32 ceildiv(i64 a, i64 b) { return (i32)((a + b - 1) / b); }
inline u32 uceildiv(u64 a, u64 b) { return b ? (u32)((a + b - 1) / b) : 0; }
inline i32 ceildivpow2(i64 a, int b) {
    return (i32)((a + ((i64)1 << b) - 1) >> b);
}
inline i32 floordivpow2(i32 a, int b) { return a >> b; }
inline u32 uceildivpow2(u32 a, u32 b) {
    return (u32)((a + ((u64)1U << b) - 1U) >> b);
}
inline i32 imax(i32 a, i32 b) { return a > b ? a : b; }
inline i32 imin(i32 a, i32 b) { return a < b ? a : b; }
inline u32 umin(u32 a, u32 b) { return a < b ? a : b; }
inline u32 umax(u32 a, u32 b) { return a > b ? a : b; }
inline u32 uadds(u32 a, u32 b) {
    u64 s = (u64)a + b;
    return s > 0xffffffffULL ? 0xffffffffU : (u32)s;
}
inline u32 floorlog2(u32 a) {
    u32 l = 0;
    while (a > 1) { a >>= 1; ++l; }
    return l;
}

// ---------------------------------------------------------------------------
// opj_stream over Pillow's reads: a read returns what is left, at most the
// request, or -1 where nothing is; the length is the file's

struct Stream {
    const uint8_t *d;
    i64 len;
    i64 pos = 0;
    // (OPJ_SIZE_T)-1 where nothing is left
    u64 read(uint8_t *dst, u64 n) {
        i64 left = len - pos;
        if (left <= 0) return (u64)-1;
        u64 k = (u64)left < n ? (u64)left : n;
        if (dst) memcpy(dst, d + pos, k);
        pos += (i64)k;
        return k;
    }
    i64 skip(i64 n) {
        i64 left = len - pos;
        if (n <= left) {
            pos += n;
            return n;
        }
        pos = len;
        return left ? left : -1;
    }
    i64 left() const { return len - pos; }
};

inline u32 be(const uint8_t *p, int n) {
    u32 v = 0;
    for (int i = 0; i < n; ++i) v = (v << 8) | p[i];
    return v;
}

// ---------------------------------------------------------------------------
// coding parameters (opj_cp_t, opj_tcp_t, opj_tccp_t)

const int MAXRLVLS = 33;
const int MAXBANDS = 3 * MAXRLVLS - 2;

struct StepSize {
    i32 expn = 0, mant = 0;
};

struct Tccp {
    u32 csty = 0, numresolutions = 0, cblkw = 0, cblkh = 0, cblksty = 0;
    u32 qmfbid = 0, qntsty = 0, numgbits = 0;
    i32 roishift = 0;
    StepSize stepsizes[MAXBANDS];
    u32 prcw[MAXRLVLS], prch[MAXRLVLS];
};

struct Poc {
    u32 resno0 = 0, compno0 = 0, layno1 = 0, resno1 = 0, compno1 = 0;
    u32 prg = 0;
};

struct Tcp {
    u32 csty = 0, prg = 0, numlayers = 0, mct = 0;
    bool cod = false, poc = false, ppt = false;
    u32 numpocs = 0;
    Poc pocs[32];
    std::vector<Tccp> tccps;
    i32 current_part = -1;
    u32 nb_parts = 0;
    bool has_data = false;
    std::vector<uint8_t> data;       // the tile's bytes, all its parts
    std::vector<std::vector<uint8_t>> ppt_markers;
    std::vector<bool> ppt_seen;
    std::vector<uint8_t> ppt_buffer;
    bool ppt_merged = false;
    u64 ppt_pos = 0;
};

struct Comp {
    u32 dx = 0, dy = 0, prec = 0, sgnd = 0;
    u32 resno_decoded = 0;
};

struct Image {
    u32 x0 = 0, y0 = 0, x1 = 0, y1 = 0, numcomps = 0;
    int color_space = CS_UNSPECIFIED;
    std::vector<Comp> comps;
};

// marker states (J2K_STATE_*)
enum {
    ST_MHSOC = 1, ST_MHSIZ = 2, ST_MH = 4, ST_TPHSOT = 8, ST_TPH = 16,
    ST_MT = 32, ST_NEOC = 64, ST_DATA = 128, ST_EOC = 256, ST_ERR = 32768
};

enum {
    MS_SOC = 0xff4f, MS_SOT = 0xff90, MS_SOD = 0xff93, MS_EOC = 0xffd9,
    MS_CAP = 0xff50, MS_SIZ = 0xff51, MS_COD = 0xff52, MS_COC = 0xff53,
    MS_CPF = 0xff59, MS_TLM = 0xff55, MS_PLM = 0xff57, MS_PLT = 0xff58,
    MS_QCD = 0xff5c, MS_QCC = 0xff5d, MS_RGN = 0xff5e, MS_POC = 0xff5f,
    MS_PPM = 0xff60, MS_PPT = 0xff61, MS_CRG = 0xff63, MS_COM = 0xff64,
    MS_CBD = 0xff78, MS_MCC = 0xff75, MS_MCT = 0xff74, MS_MCO = 0xff77,
    MS_SOP = 0xff91, MS_EPH = 0xff92, MS_UNK = 0
};

// the marker table (j2k_memory_marker_handler_tab): the states a marker
// may come in, -1 for no handler (SOP) or an unknown marker
struct Handler {
    u32 id;
    u32 states;
};

const Handler HANDLERS[] = {
    {MS_SOT, ST_MH | ST_TPHSOT}, {MS_COD, ST_MH | ST_TPH},
    {MS_COC, ST_MH | ST_TPH}, {MS_RGN, ST_MH | ST_TPH},
    {MS_QCD, ST_MH | ST_TPH}, {MS_QCC, ST_MH | ST_TPH},
    {MS_POC, ST_MH | ST_TPH}, {MS_SIZ, ST_MHSIZ}, {MS_TLM, ST_MH},
    {MS_PLM, ST_MH}, {MS_PLT, ST_TPH}, {MS_PPM, ST_MH}, {MS_PPT, ST_TPH},
    {MS_SOP, 0}, {MS_CRG, ST_MH}, {MS_COM, ST_MH | ST_TPH},
    {MS_MCT, ST_MH | ST_TPH}, {MS_CBD, ST_MH}, {MS_CAP, ST_MH},
    {MS_CPF, ST_MH}, {MS_MCC, ST_MH | ST_TPH}, {MS_MCO, ST_MH | ST_TPH},
};

Handler handler_of(u32 id) {
    for (const Handler &h : HANDLERS)
        if (h.id == id) return h;
    return Handler{MS_UNK, ST_MH | ST_TPH};
}

struct Decoder;
struct Tile;
bool decode_tile_data(Decoder &j, u32 tileno, Tile &tile,
                      std::vector<uint8_t> &buf);

struct Decoder {
    Stream s;
    Image image;
    // cp
    u32 tx0 = 0, ty0 = 0, tdx = 0, tdy = 0, tw = 0, th = 0;
    Tcp default_tcp;
    std::vector<Tcp> tcps;
    bool ppm = false;
    std::vector<std::vector<uint8_t>> ppm_markers;
    std::vector<bool> ppm_seen;
    std::vector<uint8_t> ppm_buffer;
    u64 ppm_pos = 0;
    u32 ihdr_w = 0, ihdr_h = 0;
    // decoder state
    u32 state = 0;
    u32 current_tile = 0;
    u32 sot_length = 0;
    bool last_tile_part = false;
    bool can_decode = false;
    u32 nb_tile_parts_correction = 0;

    Tcp &tcp_here() {
        return state == ST_TPH ? tcps[current_tile] : default_tcp;
    }

    // ---- marker segments (opj_j2k_read_*) -------------------------------

    bool read_siz(const uint8_t *p, u32 size) {
        if (size < 36) return false;
        u32 remaining = size - 36;
        u32 nb_comp = remaining / 3;
        if (remaining % 3 != 0) return false;
        image.x1 = be(p + 2, 4);
        image.y1 = be(p + 6, 4);
        image.x0 = be(p + 10, 4);
        image.y0 = be(p + 14, 4);
        tdx = be(p + 18, 4);
        tdy = be(p + 22, 4);
        tx0 = be(p + 26, 4);
        ty0 = be(p + 30, 4);
        u32 csiz = be(p + 34, 2);
        if (csiz >= 16385) return false;
        image.numcomps = csiz;
        if (csiz != nb_comp) return false;
        if (image.x0 >= image.x1 || image.y0 >= image.y1) return false;
        if (tdx == 0 || tdy == 0) return false;
        // tile offsets
        if (tx0 > image.x0 || ty0 > image.y0 ||
            (u64)tx0 + tdx <= image.x0 || (u64)ty0 + tdy <= image.y0)
            return false;
        if (ihdr_w > 0 && ihdr_h > 0 &&
            (ihdr_w != image.x1 - image.x0 || ihdr_h != image.y1 - image.y0))
            return false;
        image.comps.assign(csiz, Comp());
        const uint8_t *c = p + 36;
        for (u32 i = 0; i < csiz; ++i, c += 3) {
            Comp &cp = image.comps[i];
            cp.prec = (c[0] & 0x7f) + 1;
            cp.sgnd = c[0] >> 7;
            cp.dx = c[1];
            cp.dy = c[2];
            if (cp.dx < 1 || cp.dx > 255 || cp.dy < 1 || cp.dy > 255)
                return false;
            if (cp.prec > 31) return false;   // prec above 38 refused too
        }
        tw = uceildiv((u64)image.x1 - tx0, tdx);
        th = uceildiv((u64)image.y1 - ty0, tdy);
        if (tw == 0 || th == 0 || tw > 65535 / th) return false;
        default_tcp.tccps.assign(csiz, Tccp());
        tcps.assign((size_t)tw * th, Tcp());
        state = ST_MH;
        return true;
    }

    // opj_j2k_read_SPCod_SPCoc: p at the number of decompositions
    bool read_spcod(u32 compno, const uint8_t *p, u32 &size) {
        Tcp &tcp = tcp_here();
        if (compno >= image.numcomps) return false;
        Tccp &t = tcp.tccps[compno];
        if (size < 5) return false;
        t.numresolutions = p[0] + 1u;
        if (t.numresolutions > (u32)MAXRLVLS) return false;
        t.cblkw = p[1] + 2u;
        t.cblkh = p[2] + 2u;
        if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12)
            return false;
        t.cblksty = p[3];
        if (t.cblksty & 0x80) return false;   // mixed HT
        t.qmfbid = p[4];
        if (t.qmfbid > 1) return false;
        p += 5;
        size -= 5;
        if (t.csty & 1) {
            if (size < t.numresolutions) return false;
            for (u32 r = 0; r < t.numresolutions; ++r) {
                u32 v = p[r];
                if (r != 0 && ((v & 0xf) == 0 || (v >> 4) == 0)) return false;
                t.prcw[r] = v & 0xf;
                t.prch[r] = v >> 4;
            }
            size -= t.numresolutions;
        } else {
            for (u32 r = 0; r < t.numresolutions; ++r) {
                t.prcw[r] = 15;
                t.prch[r] = 15;
            }
        }
        return true;
    }

    void copy_tccp_params(Tcp &tcp) {
        Tccp &r = tcp.tccps[0];
        for (u32 i = 1; i < image.numcomps; ++i) {
            Tccp &t = tcp.tccps[i];
            t.numresolutions = r.numresolutions;
            t.cblkw = r.cblkw;
            t.cblkh = r.cblkh;
            t.cblksty = r.cblksty;
            t.qmfbid = r.qmfbid;
            memcpy(t.prcw, r.prcw, sizeof t.prcw);
            memcpy(t.prch, r.prch, sizeof t.prch);
        }
    }

    bool read_cod(const uint8_t *p, u32 size) {
        Tcp &tcp = tcp_here();
        tcp.cod = true;             // a second COD reads over the first
        if (size < 5) return false;
        tcp.csty = p[0];
        if (tcp.csty & ~7u) return false;   // unknown Scod
        tcp.prg = p[1];
        if (tcp.prg > 4) tcp.prg = 0xffffffffu;   // unknown: fails at decode
        tcp.numlayers = be(p + 2, 2);
        if (tcp.numlayers < 1) return false;
        tcp.mct = p[4];
        if (tcp.mct > 1) return false;
        for (u32 i = 0; i < image.numcomps; ++i)
            tcp.tccps[i].csty = tcp.csty & 1;
        u32 rest = size - 5;
        if (!read_spcod(0, p + 5, rest)) return false;
        if (rest != 0) return false;
        copy_tccp_params(tcp);
        return true;
    }

    bool read_coc(const uint8_t *p, u32 size) {
        Tcp &tcp = tcp_here();
        u32 room = image.numcomps <= 256 ? 1 : 2;
        if (size < room + 1) return false;
        u32 compno = be(p, room);
        if (compno >= image.numcomps) return false;
        tcp.tccps[compno].csty = p[room];
        u32 rest = size - room - 1;
        if (!read_spcod(compno, p + room + 1, rest)) return false;
        return rest == 0;
    }

    // opj_j2k_read_SQcd_SQcc
    bool read_sqcd(u32 compno, const uint8_t *p, u32 &size) {
        Tcp &tcp = tcp_here();
        if (compno >= image.numcomps) return false;
        Tccp &t = tcp.tccps[compno];
        if (size < 1) return false;
        u32 v = p[0];
        ++p;
        --size;
        t.qntsty = v & 0x1f;
        t.numgbits = v >> 5;
        u32 numbands;
        if (t.qntsty == 1) {
            numbands = 1;
        } else {
            numbands = t.qntsty == 0 ? size : size / 2;
            if (numbands > (u32)MAXBANDS) {
                // only the first MAXBANDS kept, the rest skipped
            }
        }
        if (t.qntsty == 0) {
            if (size < numbands) return false;
            for (u32 b = 0; b < numbands; ++b) {
                if (b < (u32)MAXBANDS) {
                    t.stepsizes[b].expn = (i32)(p[b] >> 3);
                    t.stepsizes[b].mant = 0;
                }
            }
            size -= numbands;
        } else {
            if (size < 2 * numbands) return false;
            for (u32 b = 0; b < numbands; ++b) {
                u32 w = be(p + 2 * b, 2);
                if (b < (u32)MAXBANDS) {
                    t.stepsizes[b].expn = (i32)(w >> 11);
                    t.stepsizes[b].mant = (i32)(w & 0x7ff);
                }
            }
            size -= 2 * numbands;
        }
        if (t.qntsty == 1) {
            for (int b = 1; b < MAXBANDS; ++b) {
                i32 e = t.stepsizes[0].expn - (b - 1) / 3;
                t.stepsizes[b].expn = e > 0 ? e : 0;
                t.stepsizes[b].mant = t.stepsizes[0].mant;
            }
        }
        return true;
    }

    bool read_qcd(const uint8_t *p, u32 size) {
        Tcp &tcp = tcp_here();
        if (!read_sqcd(0, p, size)) return false;
        if (size != 0) return false;
        Tccp &r = tcp.tccps[0];
        for (u32 i = 1; i < image.numcomps; ++i) {
            Tccp &t = tcp.tccps[i];
            t.qntsty = r.qntsty;
            t.numgbits = r.numgbits;
            memcpy(t.stepsizes, r.stepsizes, sizeof t.stepsizes);
        }
        return true;
    }

    bool read_qcc(const uint8_t *p, u32 size) {
        u32 room = image.numcomps <= 256 ? 1 : 2;
        if (size < room) return false;
        u32 compno = be(p, room);
        if (compno >= image.numcomps) return false;
        size -= room;
        if (!read_sqcd(compno, p + room, size)) return false;
        return size == 0;
    }

    bool read_rgn(const uint8_t *p, u32 size) {
        u32 room = image.numcomps <= 256 ? 1 : 2;
        if (size != 2 + room) return false;
        u32 compno = be(p, room);
        if (compno >= image.numcomps) return false;
        tcp_here().tccps[compno].roishift = p[room + 1];
        return true;
    }

    bool read_poc(const uint8_t *p, u32 size) {
        Tcp &tcp = tcp_here();
        u32 nb_comp = image.numcomps;
        u32 room = nb_comp <= 256 ? 1 : 2;
        u32 chunk = 5 + 2 * room;
        u32 current = size / chunk;
        if (size % chunk != 0 || current == 0) return false;
        u32 old = tcp.poc ? tcp.numpocs + 1 : 0;
        current += old;
        if (current >= 32) return false;
        for (u32 i = old; i < current; ++i) {
            Poc &c = tcp.pocs[i];
            c.resno0 = p[0];
            c.compno0 = be(p + 1, room);
            c.layno1 = be(p + 1 + room, 2);
            c.resno1 = p[3 + room];
            c.compno1 = be(p + 4 + room, room);
            c.prg = p[4 + 2 * room];
            c.compno1 = umin(c.compno1, nb_comp);
            p += chunk;
        }
        tcp.numpocs = current - 1;
        tcp.poc = true;
        return true;
    }

    bool read_ppm(const uint8_t *p, u32 size) {
        if (size < 2) return false;
        ppm = true;
        u32 z = p[0];
        if (ppm_markers.size() <= z) {
            ppm_markers.resize(z + 1);
            ppm_seen.resize(z + 1, false);
        }
        if (ppm_seen[z]) return false;
        ppm_seen[z] = true;
        ppm_markers[z].assign(p + 1, p + size);
        return true;
    }

    bool read_ppt(const uint8_t *p, u32 size) {
        if (size < 2) return false;
        if (ppm) return false;
        Tcp &tcp = tcps[current_tile];
        tcp.ppt = true;
        u32 z = p[0];
        if (tcp.ppt_markers.size() <= z) {
            tcp.ppt_markers.resize(z + 1);
            tcp.ppt_seen.resize(z + 1, false);
        }
        if (tcp.ppt_seen[z]) return false;
        tcp.ppt_seen[z] = true;
        tcp.ppt_markers[z].assign(p + 1, p + size);
        return true;
    }

    // TLM's lengths serve random tile access only: a TLM OpenJPEG finds
    // invalid is a warning
    bool read_tlm(const uint8_t *, u32 size) { return size >= 2; }

    bool read_plt(const uint8_t *p, u32 size) {
        if (size < 1) return false;
        u32 len = 0;
        for (u32 i = 1; i < size; ++i) {
            len = (len << 7) | (p[i] & 0x7f);
            if (!(p[i] & 0x80)) len = 0;
        }
        return len == 0;
    }

    bool read_crg(const uint8_t *, u32 size) {
        return size == image.numcomps * 4;
    }

    bool read_cbd(const uint8_t *p, u32 size) {
        u32 n = image.numcomps;
        if (size < 2 || size - 2 != n) return false;
        if (be(p, 2) != n) return false;
        for (u32 i = 0; i < n; ++i) {
            u32 v = p[2 + i];
            image.comps[i].sgnd = (v >> 7) & 1;
            image.comps[i].prec = (v & 0x7f) + 1;
            if (image.comps[i].prec > 31) return false;
        }
        return true;
    }

    bool read_sot(const uint8_t *p, u32 size);
    bool read_sod();

    bool handle(u32 id, const uint8_t *p, u32 size) {
        switch (id) {
        case MS_SOT: return read_sot(p, size);
        case MS_COD: return read_cod(p, size);
        case MS_COC: return read_coc(p, size);
        case MS_RGN: return read_rgn(p, size);
        case MS_QCD: return read_qcd(p, size);
        case MS_QCC: return read_qcc(p, size);
        case MS_POC: return read_poc(p, size);
        case MS_SIZ: return read_siz(p, size);
        case MS_TLM: return read_tlm(p, size);
        case MS_PLM: return size >= 1;
        case MS_PLT: return read_plt(p, size);
        case MS_PPM: return read_ppm(p, size);
        case MS_PPT: return read_ppt(p, size);
        case MS_CRG: return read_crg(p, size);
        case MS_COM: return true;
        case MS_CBD: return read_cbd(p, size);
        case MS_CAP: return true;
        case MS_CPF: return true;
        default: return false;   // Part 2 MCT, MCC, MCO: not decoded here
        }
    }

    // opj_j2k_read_unk: 2 bytes at a time until a known marker
    bool read_unk(u32 &marker) {
        uint8_t b[2];
        for (;;) {
            if (s.read(b, 2) != 2) return false;
            u32 m = be(b, 2);
            if (m < 0xff00) continue;
            Handler h = handler_of(m);
            if (!(state & h.states)) return false;
            if (h.id != MS_UNK) {
                marker = h.id;
                return true;
            }
        }
    }

    bool read_marker_segment(u32 id, std::vector<uint8_t> &buf) {
        uint8_t b[2];
        if (s.read(b, 2) != 2) return false;
        u32 size = be(b, 2);
        if (size < 2) return false;
        size -= 2;
        buf.resize(size + 1);
        if (size && s.read(buf.data(), size) != size) return false;
        return handle(id, buf.data(), size);
    }

    // opj_j2k_read_header_procedure and the merge of PPM
    bool read_main_header() {
        state = ST_MHSOC;
        uint8_t b[2];
        if (s.read(b, 2) != 2 || be(b, 2) != MS_SOC) return false;
        state = ST_MHSIZ;
        if (s.read(b, 2) != 2) return false;
        u32 marker = be(b, 2);
        bool has_siz = false, has_cod = false, has_qcd = false;
        std::vector<uint8_t> buf;
        while (marker != MS_SOT) {
            if (marker < 0xff00) return false;
            Handler h = handler_of(marker);
            if (h.id == MS_UNK) {
                if (!read_unk(marker)) return false;
                if (marker == MS_SOT) break;
                h = handler_of(marker);
            }
            if (h.id == MS_SIZ) has_siz = true;
            if (h.id == MS_COD) has_cod = true;
            if (h.id == MS_QCD) has_qcd = true;
            if (!(state & h.states)) return false;
            if (h.id == MS_SOP) return false;
            if (!read_marker_segment(h.id, buf)) return false;
            if (s.read(b, 2) != 2) return false;
            marker = be(b, 2);
        }
        if (!has_siz || !has_cod || !has_qcd) return false;
        if (!merge_ppm()) return false;
        state = ST_TPHSOT;
        // opj_j2k_copy_default_tcp_and_create_tcd
        for (Tcp &t : tcps) {
            t = default_tcp;
            t.cod = false;
            t.ppt = false;
            t.current_part = -1;
        }
        return true;
    }

    bool merge_ppm() {
        if (!ppm) return true;
        u64 remaining = 0;
        std::vector<uint8_t> out;
        for (size_t i = 0; i < ppm_markers.size(); ++i) {
            if (!ppm_seen[i]) continue;
            const uint8_t *d = ppm_markers[i].data();
            u64 n = ppm_markers[i].size();
            if (remaining >= n) {
                out.insert(out.end(), d, d + n);
                remaining -= n;
                n = 0;
            } else {
                out.insert(out.end(), d, d + remaining);
                d += remaining;
                n -= remaining;
                remaining = 0;
            }
            while (n > 0) {
                if (n < 4) return false;
                u32 nppm = be(d, 4);
                d += 4;
                n -= 4;
                if (n >= nppm) {
                    out.insert(out.end(), d, d + nppm);
                    d += nppm;
                    n -= nppm;
                } else {
                    out.insert(out.end(), d, d + n);
                    remaining = nppm - n;
                    n = 0;
                }
            }
        }
        if (remaining != 0) return false;
        ppm_buffer.swap(out);
        ppm_pos = 0;
        return true;
    }

    bool merge_ppt(Tcp &tcp) {
        if (tcp.ppt_merged) return false;
        if (!tcp.ppt) return true;
        tcp.ppt_merged = true;
        tcp.ppt_buffer.clear();
        for (size_t i = 0; i < tcp.ppt_markers.size(); ++i)
            if (tcp.ppt_seen[i])
                tcp.ppt_buffer.insert(tcp.ppt_buffer.end(),
                                      tcp.ppt_markers[i].begin(),
                                      tcp.ppt_markers[i].end());
        tcp.ppt_pos = 0;
        return true;
    }

    // opj_j2k_read_tile_header: go_on false at the end; the tile read is
    // current_tile
    bool read_tile_header(bool &go_on);
    // opj_j2k_decode_tile: the tile read_tile_header's caller initialised
    bool decode_tile(u32 tileno, Tile &tile, std::vector<uint8_t> &buf);
};

bool Decoder::read_sot(const uint8_t *p, u32 size) {
    if (size != 8) return false;
    current_tile = be(p, 2);
    u32 tot_len = be(p + 2, 4);
    u32 part = p[6];
    u32 num_parts = p[7];
    if (current_tile >= tw * th) return false;
    Tcp &tcp = tcps[current_tile];
    if (tcp.current_part + 1 != (i32)part) return false;
    tcp.current_part = (i32)part;
    if (tot_len != 0 && tot_len < 14) {
        if (tot_len != 12) return false;     // 12: an empty tile-part
    }
    if (!tot_len) last_tile_part = true;
    if (tcp.nb_parts != 0 && part >= tcp.nb_parts) {
        last_tile_part = true;
        return false;
    }
    if (num_parts != 0) {
        num_parts += nb_tile_parts_correction;
        if (tcp.nb_parts && part >= tcp.nb_parts) {
            last_tile_part = true;
            return false;
        }
        if (part >= num_parts) {
            last_tile_part = true;
            return false;
        }
        tcp.nb_parts = num_parts;
    }
    if (tcp.nb_parts && tcp.nb_parts == part + 1) can_decode = true;
    sot_length = last_tile_part ? 0 : tot_len - 12;
    state = ST_TPH;
    return true;
}

bool Decoder::read_sod() {
    Tcp &tcp = tcps[current_tile];
    if (last_tile_part) {
        sot_length = (u32)(s.left() - 2);
    } else if (sot_length >= 2) {
        sot_length -= 2;
    }
    u64 got = 0;
    if (sot_length) {
        if ((i64)sot_length > s.left()) return false;   // strict
        size_t at = tcp.data.size();
        tcp.data.resize(at + sot_length);
        got = s.read(tcp.data.data() + at, sot_length);
        if (got == (u64)-1) {
            tcp.data.resize(at);
        } else {
            tcp.data.resize(at + got);
        }
        tcp.has_data = true;
    }
    state = got != sot_length ? ST_NEOC : ST_TPHSOT;
    return true;
}

bool Decoder::read_tile_header(bool &go_on) {
    u32 marker = MS_SOT;
    const u32 nb_tiles = tw * th;
    if (state == ST_EOC) {
        marker = MS_EOC;
    } else if (state != ST_TPHSOT) {
        return false;
    }
    std::vector<uint8_t> buf;
    uint8_t b[2];
    while (!can_decode && marker != MS_EOC) {
        while (marker != MS_SOD) {
            if (s.left() == 0) {
                state = ST_NEOC;
                break;
            }
            if (s.read(b, 2) != 2) return false;
            u32 size = be(b, 2);
            if (size < 2) return false;
            if (marker == 0x8080 && s.left() == 0) {
                state = ST_NEOC;
                break;
            }
            if ((state & ST_TPH) && sot_length != 0) {
                if (sot_length < size + 2) return false;
                sot_length -= size + 2;
            }
            size -= 2;
            Handler h = handler_of(marker);
            if (!(state & h.states)) return false;
            if (size > buf.size() && (i64)size > s.left()) return false;
            buf.resize(size + 1);
            if (size && s.read(buf.data(), size) != size) return false;
            if (h.id == MS_UNK || h.id == MS_SOP) return false;
            if (!handle(h.id, buf.data(), size)) return false;
            if (s.read(b, 2) != 2) return false;
            marker = be(b, 2);
        }
        if (s.left() == 0 && state == ST_NEOC) break;
        if (!read_sod()) return false;
        if (!can_decode) {
            if (s.read(b, 2) != 2) {
                if (current_tile + 1 == nb_tiles) {
                    u32 t = 0;
                    for (; t < nb_tiles; ++t)
                        if (tcps[t].current_part == 0 && tcps[t].nb_parts == 0)
                            break;
                    if (t < nb_tiles) {
                        current_tile = t;
                        marker = MS_EOC;
                        state = ST_EOC;
                        break;
                    }
                }
                return false;
            }
            marker = be(b, 2);
        }
    }
    if (marker == MS_EOC && state != ST_EOC) {
        current_tile = 0;
        state = ST_EOC;
    }
    if (!can_decode) {
        while (current_tile < nb_tiles && !tcps[current_tile].has_data)
            ++current_tile;
        if (current_tile == nb_tiles) {
            go_on = false;
            return true;
        }
    }
    if (!merge_ppt(tcps[current_tile])) return false;
    go_on = true;
    state |= ST_DATA;
    return true;
}

bool Decoder::decode_tile(u32 tileno, Tile &tile, std::vector<uint8_t> &buf) {
    if (!(state & ST_DATA) || tileno != current_tile) return false;
    Tcp &tcp = tcps[tileno];
    if (!tcp.has_data) return false;
    if (!decode_tile_data(*this, tileno, tile, buf)) return false;
    tcp.data.clear();
    tcp.data.shrink_to_fit();
    tcp.has_data = false;
    can_decode = false;
    state &= ~(u32)ST_DATA;
    if (s.left() == 0 && state == ST_NEOC) return true;
    if (state != ST_EOC) {
        uint8_t b[2];
        if (s.read(b, 2) != 2) return false;   // strict: "Stream too short"
        u32 marker = be(b, 2);
        if (marker == MS_EOC) {
            current_tile = 0;
            state = ST_EOC;
        } else if (marker != MS_SOT) {
            if (s.left() == 0) {
                state = ST_NEOC;
                return true;
            }
            return false;
        }
    }
    return true;
}

// ---------------------------------------------------------------------------
// the JP2 layer (jp2.c): the boxes before the codestream, the colour space
// it gives the image, and the boxes read after it by opj_end_decompress

struct Jp2 {
    enum { NONE = 0, SIGNATURE = 1, FILE_TYPE = 2, HEADER = 4,
           CODESTREAM = 8, END_CODESTREAM = 16, UNKNOWN = 0x7fffffff };
    u32 state = NONE;
    bool has_jp2h = false, has_ihdr = false, ihdr_read = false;
    bool has_colr = false, has_pclr = false, has_cmap = false;
    bool has_cdef = false;
    u32 pclr_channels = 0;
    u32 w = 0, h = 0, numcomps = 0, meth = 0, enumcs = 0;
};

// opj_jp2_read_boxhdr from the stream; false at its end or on a length
// it cannot handle
bool read_boxhdr(Stream &s, u32 &length, u32 &type, u32 &nread) {
    uint8_t h[8];
    u64 got = s.read(h, 8);
    nread = got == (u64)-1 ? 0 : (u32)got;
    if (got != 8) return false;
    length = be(h, 4);
    type = be(h + 4, 4);
    if (length == 0) {
        i64 left = s.left();
        if (left > (i64)(0xffffffffu - 8u)) return false;
        length = (u32)left + 8u;
        return true;
    }
    if (length == 1) {
        got = s.read(h, 8);
        if (got != 8) {
            if (got != (u64)-1 && got > 0) nread += (u32)got;
            return false;
        }
        nread = 16;
        if (be(h, 4) != 0) return false;
        length = be(h + 4, 4);
    }
    return true;
}

const u32 BOX_JP = 0x6a502020, BOX_FTYP = 0x66747970, BOX_JP2H = 0x6a703268,
          BOX_JP2C = 0x6a703263, BOX_IHDR = 0x69686472,
          BOX_COLR = 0x636f6c72, BOX_BPCC = 0x62706363,
          BOX_PCLR = 0x70636c72, BOX_CMAP = 0x636d6170,
          BOX_CDEF = 0x63646566;

bool is_img_box(u32 t) {
    return t == BOX_IHDR || t == BOX_COLR || t == BOX_BPCC ||
           t == BOX_PCLR || t == BOX_CMAP || t == BOX_CDEF;
}

bool read_img_box(Jp2 &jp2, Decoder &j, u32 type, const uint8_t *p,
                  u32 size) {
    switch (type) {
    case BOX_IHDR:
        if (jp2.ihdr_read) return true;     // the first one kept
        if (size != 14) return false;
        jp2.h = be(p, 4);
        jp2.w = be(p + 4, 4);
        jp2.numcomps = be(p + 8, 2);
        if (jp2.numcomps - 1u >= 16384u) return false;
        jp2.ihdr_read = true;
        j.ihdr_w = jp2.w;
        j.ihdr_h = jp2.h;
        jp2.has_ihdr = true;
        return true;
    case BOX_COLR:
        if (size < 3) return false;
        if (jp2.has_colr) return true;       // the first one kept
        jp2.meth = p[0];
        if (jp2.meth == 1) {
            if (size < 7) return false;
            jp2.enumcs = be(p + 3, 4);
            if (jp2.enumcs == 14 && size > 7 && size < 35)
                return false;          // CIELab's fields cut short
            jp2.has_colr = true;
        } else if (jp2.meth == 2) {
            jp2.has_colr = true;
        }
        return true;
    case BOX_BPCC:
        return size == jp2.numcomps;
    case BOX_PCLR: {
        if (jp2.has_pclr) return false;
        if (size < 3) return false;
        u32 entries = be(p, 2), channels = p[2];
        if (entries == 0 || entries > 1024 || channels == 0) return false;
        if (size < 3 + channels) return false;
        jp2.has_pclr = true;
        jp2.pclr_channels = channels;
        u64 at = 3 + channels;
        for (u32 e = 0; e < entries; ++e)
            for (u32 c = 0; c < channels; ++c) {
                u32 bytes = ((p[3 + c] & 0x7f) + 1 + 7) >> 3;
                if (bytes > 4) bytes = 4;
                if (size < at + bytes) return false;
                at += bytes;
            }
        return true;
    }
    case BOX_CMAP:
        if (!jp2.has_pclr || jp2.has_cmap) return false;
        if (size < jp2.pclr_channels * 4) return false;
        jp2.has_cmap = true;
        return true;
    case BOX_CDEF: {
        if (jp2.has_cdef) return false;
        if (size < 2) return false;
        u32 n = be(p, 2);
        if (n == 0) return false;
        if (size < 2 + (u64)n * 6) return false;
        jp2.has_cdef = true;
        return true;
    }
    }
    return true;
}

// opj_jp2_read_jp2h
bool read_jp2h(Jp2 &jp2, Decoder &j, const uint8_t *p, u32 size) {
    if ((jp2.state & Jp2::FILE_TYPE) != Jp2::FILE_TYPE) return false;
    bool has_ihdr = false;
    while (size > 0) {
        if (size < 8) return false;
        u32 length = be(p, 4), type = be(p + 4, 4), hdr = 8;
        if (length == 1) {
            if (size < 16) return false;
            if (be(p + 8, 4) != 0) return false;
            length = be(p + 12, 4);
            hdr = 16;
            if (length == 0) return false;
        } else if (length == 0) {
            return false;
        }
        if (length < hdr) return false;
        if (length > size) return false;
        if (is_img_box(type) &&
            !read_img_box(jp2, j, type, p + hdr, length - hdr))
            return false;
        if (type == BOX_IHDR) has_ihdr = true;
        p += length;
        size -= length;
    }
    if (!has_ihdr) return false;
    jp2.state |= Jp2::HEADER;
    jp2.has_jp2h = true;
    return true;
}

// opj_jp2_read_header_procedure: true at the codestream box, and where
// no box header can be read (the stream's end, a length past 2^32: the
// codestream is then read from where the stream stands)
bool jp2_read_boxes(Jp2 &jp2, Decoder &j) {
    Stream &s = j.s;
    std::vector<uint8_t> data;
    u32 length, type, nread;
    while (read_boxhdr(s, length, type, nread)) {
        if (type == BOX_JP2C) {
            if (jp2.state & Jp2::HEADER) {
                jp2.state |= Jp2::CODESTREAM;
                return true;
            }
            return false;
        } else if (length == 0) {
            return false;
        } else if (length < nread) {
            return false;
        }
        bool known = type == BOX_JP || type == BOX_FTYP || type == BOX_JP2H;
        bool misplaced = is_img_box(type);
        u32 size = length - nread;
        if (known || misplaced) {
            if (!known) {
                if (!(jp2.state & Jp2::HEADER)) {
                    jp2.state |= Jp2::UNKNOWN;
                    if (s.skip(size) != (i64)size) return false;
                    continue;
                }
            }
            if ((i64)size > s.left()) return false;
            data.resize(size + 1);
            if (size && s.read(data.data(), size) != size) return false;
            const uint8_t *p = data.data();
            if (type == BOX_JP) {
                if (jp2.state != Jp2::NONE) return false;
                if (size != 4 || be(p, 4) != 0x0d0a870a) return false;
                jp2.state |= Jp2::SIGNATURE;
            } else if (type == BOX_FTYP) {
                if (jp2.state != Jp2::SIGNATURE) return false;
                if (size < 8 || (size - 8) % 4 != 0) return false;
                jp2.state |= Jp2::FILE_TYPE;
            } else if (type == BOX_JP2H) {
                if (!read_jp2h(jp2, j, p, size)) return false;
            } else if (!read_img_box(jp2, j, type, p, size)) {
                return false;
            }
        } else {
            if (!(jp2.state & Jp2::SIGNATURE)) return false;
            if (!(jp2.state & Jp2::FILE_TYPE)) return false;
            jp2.state |= Jp2::UNKNOWN;
            if (s.skip(size) != (i64)size) {
                return (jp2.state & Jp2::CODESTREAM) != 0;
            }
        }
    }
    return true;
}

// ---------------------------------------------------------------------------
// the tile (tcd.c): components, resolutions, bands, precincts, code-blocks

struct Seg {
    u32 len = 0, numpasses = 0, real_num_passes = 0, maxpasses = 0;
    u32 numnewpasses = 0, newlen = 0;
};

struct Chunk {
    const uint8_t *data;
    u32 len;
};

struct Cblk {
    i32 x0, y0, x1, y1;
    u32 numbps = 0, numlenbits = 0, numnewpasses = 0;
    u32 numsegs = 0, real_num_segs = 0;
    std::vector<Seg> segs;
    std::vector<Chunk> chunks;
};

// a tag tree (tgt.c)
struct TagTree {
    struct Node {
        i32 parent;
        i32 value, low;
    };
    std::vector<Node> nodes;
    void init(u32 w, u32 h) {
        nodes.clear();
        std::vector<u32> ws, hs;
        u32 nw = w, nh = h;
        u64 n = 0;
        do {
            ws.push_back(nw);
            hs.push_back(nh);
            n += (u64)nw * nh;
            nw = (nw + 1) / 2;
            nh = (nh + 1) / 2;
        } while (ws.back() * hs.back() > 1);
        if ((u64)w * h == 0) return;
        nodes.resize(n);
        u64 base = 0;
        for (size_t lv = 0; lv < ws.size(); ++lv) {
            u64 next = base + (u64)ws[lv] * hs[lv];
            for (u32 j = 0; j < hs[lv]; ++j)
                for (u32 i = 0; i < ws[lv]; ++i) {
                    Node &nd = nodes[base + (u64)j * ws[lv] + i];
                    if (lv + 1 < ws.size())
                        nd.parent = (i32)(next + (u64)(j / 2) * ws[lv + 1] +
                                          i / 2);
                    else
                        nd.parent = -1;
                }
            base = next;
        }
        reset();
    }
    void reset() {
        for (Node &n : nodes) {
            n.value = 999;
            n.low = 0;
        }
    }
};

struct Precinct {
    i32 x0, y0, x1, y1;
    u32 cw = 0, ch = 0;
    std::vector<Cblk> cblks;
    TagTree incl, imsb;
};

struct Band {
    i32 x0, y0, x1, y1;
    u32 bandno = 0;
    float stepsize = 0;
    i32 numbps = 0;
    std::vector<Precinct> precincts;
    bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Res {
    i32 x0, y0, x1, y1;
    u32 pw = 0, ph = 0, numbands = 0;
    Band bands[3];
};

struct TileComp {
    i32 x0, y0, x1, y1;
    u32 numresolutions = 0, minimum_num_resolutions = 0;
    std::vector<Res> resolutions;
    std::vector<i32> data;        // floats for 9/7, by their bits
};

struct Tile {
    i32 x0, y0, x1, y1;
    std::vector<TileComp> comps;
};

bool init_tile(Decoder &j, u32 tileno, Tile &tile) {
    Tcp &tcp = j.tcps[tileno];
    Image &image = j.image;
    u32 p = tileno % j.tw, q = tileno / j.tw;
    u32 l_tx0 = j.tx0 + p * j.tdx;
    tile.x0 = (i32)umax(l_tx0, image.x0);
    tile.x1 = (i32)umin(uadds(l_tx0, j.tdx), image.x1);
    if (tile.x0 < 0 || tile.x1 < 0) return false;
    u32 l_ty0 = j.ty0 + q * j.tdy;
    tile.y0 = (i32)umax(l_ty0, image.y0);
    tile.y1 = (i32)umin(uadds(l_ty0, j.tdy), image.y1);
    if (tile.y0 < 0 || tile.y1 < 0) return false;
    if (tcp.tccps[0].numresolutions == 0) return false;
    tile.comps.assign(image.numcomps, TileComp());
    for (u32 compno = 0; compno < image.numcomps; ++compno) {
        Comp &ic = image.comps[compno];
        Tccp &tccp = tcp.tccps[compno];
        TileComp &tc = tile.comps[compno];
        ic.resno_decoded = 0;
        tc.x0 = ceildiv(tile.x0, ic.dx);
        tc.y0 = ceildiv(tile.y0, ic.dy);
        tc.x1 = ceildiv(tile.x1, ic.dx);
        tc.y1 = ceildiv(tile.y1, ic.dy);
        tc.numresolutions = tccp.numresolutions;
        tc.minimum_num_resolutions = tccp.numresolutions;
        tc.resolutions.assign(tc.numresolutions, Res());
        u32 level = tc.numresolutions;
        const StepSize *step = tccp.stepsizes;
        for (u32 resno = 0; resno < tc.numresolutions; ++resno) {
            Res &res = tc.resolutions[resno];
            --level;
            res.x0 = ceildivpow2(tc.x0, level);
            res.y0 = ceildivpow2(tc.y0, level);
            res.x1 = ceildivpow2(tc.x1, level);
            res.y1 = ceildivpow2(tc.y1, level);
            u32 pdx = tccp.prcw[resno], pdy = tccp.prch[resno];
            i32 tl_x = floordivpow2(res.x0, pdx) << pdx;
            i32 tl_y = floordivpow2(res.y0, pdy) << pdy;
            u64 brx = (u64)(u32)ceildivpow2(res.x1, pdx) << pdx;
            u64 bry = (u64)(u32)ceildivpow2(res.y1, pdy) << pdy;
            if (brx > 0x7fffffffu || bry > 0x7fffffffu) return false;
            res.pw = res.x0 == res.x1 ? 0 : (u32)(((i32)brx - tl_x) >> pdx);
            res.ph = res.y0 == res.y1 ? 0 : (u32)(((i32)bry - tl_y) >> pdy);
            if (res.pw != 0 && 0xffffffffu / res.pw < res.ph) return false;
            u32 nprec = res.pw * res.ph;
            if (nprec > (1u << 24)) return false;
            i32 cbgx, cbgy;
            u32 cbgwexpn, cbghexpn;
            if (resno == 0) {
                cbgx = tl_x;
                cbgy = tl_y;
                cbgwexpn = pdx;
                cbghexpn = pdy;
                res.numbands = 1;
            } else {
                cbgx = ceildivpow2(tl_x, 1);
                cbgy = ceildivpow2(tl_y, 1);
                cbgwexpn = pdx - 1;
                cbghexpn = pdy - 1;
                res.numbands = 3;
            }
            u32 cbwexpn = umin(tccp.cblkw, cbgwexpn);
            u32 cbhexpn = umin(tccp.cblkh, cbghexpn);
            for (u32 bandno = 0; bandno < res.numbands; ++bandno, ++step) {
                Band &band = res.bands[bandno];
                if (resno == 0) {
                    band.bandno = 0;
                    band.x0 = ceildivpow2(tc.x0, level);
                    band.y0 = ceildivpow2(tc.y0, level);
                    band.x1 = ceildivpow2(tc.x1, level);
                    band.y1 = ceildivpow2(tc.y1, level);
                } else {
                    band.bandno = bandno + 1;
                    i64 x0b = band.bandno & 1, y0b = band.bandno >> 1;
                    band.x0 = ceildivpow2(tc.x0 - (x0b << level), level + 1);
                    band.y0 = ceildivpow2(tc.y0 - (y0b << level), level + 1);
                    band.x1 = ceildivpow2(tc.x1 - (x0b << level), level + 1);
                    band.y1 = ceildivpow2(tc.y1 - (y0b << level), level + 1);
                }
                {
                    // Table E-1's gains are not applied for the 9/7 (the
                    // DWT's two_invK stands for them)
                    i32 log2_gain = tccp.qmfbid == 0 ? 0
                                    : band.bandno == 0 ? 0
                                    : band.bandno == 3 ? 2 : 1;
                    i32 Rb = (i32)ic.prec + log2_gain;
                    band.stepsize = (float)((1.0 + step->mant / 2048.0) *
                                            pow(2.0, (i32)(Rb - step->expn)));
                }
                band.numbps = step->expn + (i32)tccp.numgbits - 1;
                band.precincts.assign(nprec, Precinct());
                for (u32 precno = 0; precno < nprec; ++precno) {
                    Precinct &prc = band.precincts[precno];
                    i32 sx = cbgx + (i32)(precno % res.pw) * (1 << cbgwexpn);
                    i32 sy = cbgy + (i32)(precno / res.pw) * (1 << cbghexpn);
                    i32 ex = sx + (1 << cbgwexpn), ey = sy + (1 << cbghexpn);
                    prc.x0 = imax(sx, band.x0);
                    prc.y0 = imax(sy, band.y0);
                    prc.x1 = imin(ex, band.x1);
                    prc.y1 = imin(ey, band.y1);
                    i32 tlcx = floordivpow2(prc.x0, cbwexpn) << cbwexpn;
                    i32 tlcy = floordivpow2(prc.y0, cbhexpn) << cbhexpn;
                    i32 brcx = ceildivpow2(prc.x1, cbwexpn) << cbwexpn;
                    i32 brcy = ceildivpow2(prc.y1, cbhexpn) << cbhexpn;
                    prc.cw = (u32)((brcx - tlcx) >> cbwexpn);
                    prc.ch = (u32)((brcy - tlcy) >> cbhexpn);
                    u64 ncb = (u64)prc.cw * prc.ch;
                    if (ncb > (1u << 24)) return false;
                    prc.cblks.assign(ncb, Cblk());
                    for (u32 k = 0; k < ncb; ++k) {
                        Cblk &cb = prc.cblks[k];
                        i32 cx = tlcx + (i32)(k % prc.cw) * (1 << cbwexpn);
                        i32 cy = tlcy + (i32)(k / prc.cw) * (1 << cbhexpn);
                        cb.x0 = imax(cx, prc.x0);
                        cb.y0 = imax(cy, prc.y0);
                        cb.x1 = imin(cx + (1 << cbwexpn), prc.x1);
                        cb.y1 = imin(cy + (1 << cbhexpn), prc.y1);
                    }
                    prc.incl.init(prc.cw, prc.ch);
                    prc.imsb.init(prc.cw, prc.ch);
                }
            }
        }
    }
    return true;
}

// ---------------------------------------------------------------------------
// the packet iterator (pi.c)

struct PiRes {
    u32 pdx, pdy, pw, ph;
};

struct PiComp {
    u32 dx, dy, numresolutions;
    std::vector<PiRes> res;
};

struct Pi {
    u32 tx0, ty0, tx1, ty1;
    u32 step_p, step_c, step_r, step_l;
    std::vector<PiComp> comps;
    std::vector<int16_t> *include;
    // poc
    u32 prg, resno0, compno0, layno0, precno0, resno1, compno1, layno1,
        precno1;
    bool first = true;
    u32 layno = 0, resno = 0, compno = 0, precno = 0, x = 0, y = 0, dx = 0,
        dy = 0;
    bool included() {
        u64 index = (u64)layno * step_l + (u64)resno * step_r +
                    (u64)compno * step_c + (u64)precno * step_p;
        if (index >= include->size()) {
            bad = true;
            return false;
        }
        if (!(*include)[index]) {
            (*include)[index] = 1;
            return true;
        }
        return false;
    }
    bool bad = false;

    void min_steps(const PiComp &comp, u32 &mdx, u32 &mdy) {
        for (u32 r = 0; r < comp.numresolutions; ++r) {
            const PiRes &res = comp.res[r];
            u32 lv = comp.numresolutions - 1 - r;
            if (res.pdx + lv < 32 && comp.dx <= 0xffffffffu / (1u << (res.pdx + lv))) {
                u32 d = comp.dx * (1u << (res.pdx + lv));
                mdx = !mdx ? d : umin(mdx, d);
            }
            if (res.pdy + lv < 32 && comp.dy <= 0xffffffffu / (1u << (res.pdy + lv))) {
                u32 d = comp.dy * (1u << (res.pdy + lv));
                mdy = !mdy ? d : umin(mdy, d);
            }
        }
    }

    // the precinct at (x, y) of the resolution, false where the position
    // is not a precinct's start (the checks of opj_pi_next_rpcl)
    bool position_precinct(const PiComp &comp) {
        const PiRes &res = comp.res[resno];
        u32 levelno = comp.numresolutions - 1 - resno;
        if ((u32)(((u64)comp.dx << levelno) >> levelno) != comp.dx ||
            (u32)(((u64)comp.dy << levelno) >> levelno) != comp.dy)
            return false;
        u64 cdx = (u64)comp.dx << levelno, cdy = (u64)comp.dy << levelno;
        u32 trx0 = (u32)((tx0 + cdx - 1) / cdx);
        u32 try0 = (u32)((ty0 + cdy - 1) / cdy);
        u32 trx1 = (u32)((tx1 + cdx - 1) / cdx);
        u32 try1 = (u32)((ty1 + cdy - 1) / cdy);
        u32 rpx = res.pdx + levelno, rpy = res.pdy + levelno;
        if (rpx >= 64 || rpy >= 64) return false;
        if ((u32)(((u64)comp.dx << rpx) >> rpx) != comp.dx ||
            (u32)(((u64)comp.dy << rpy) >> rpy) != comp.dy)
            return false;
        if (!(((u64)y % ((u64)comp.dy << rpy) == 0) ||
              ((y == ty0) && (((u64)try0 << levelno) % ((u64)1 << rpy)))))
            return false;
        if (!(((u64)x % ((u64)comp.dx << rpx) == 0) ||
              ((x == tx0) && (((u64)trx0 << levelno) % ((u64)1 << rpx)))))
            return false;
        if (res.pw == 0 || res.ph == 0) return false;
        if (trx0 == trx1 || try0 == try1) return false;
        u32 prci = ((u32)((x + cdx - 1) / cdx) >> res.pdx) - (trx0 >> res.pdx);
        u32 prcj = ((u32)((y + cdy - 1) / cdy) >> res.pdy) - (try0 >> res.pdy);
        precno = prci + prcj * res.pw;
        return true;
    }

    // opj_pi_next: the next packet of the progression, false at the end
    // (or an error: bad)
    bool next() {
        if (compno0 >= comps.size() || compno1 >= comps.size() + 1)
            return false;
        switch (prg) {
        case 0: return next_lrcp();
        case 1: return next_rlcp();
        case 2: return next_rpcl();
        case 3: return next_pcrl();
        case 4: return next_cprl();
        }
        return false;
    }

    bool next_lrcp() {
        bool resume = !first;
        first = false;
        for (layno = resume ? layno : layno0; layno < layno1; layno++) {
            for (resno = resume ? resno : resno0; resno < resno1; resno++) {
                for (compno = resume ? compno : compno0; compno < compno1;
                     compno++) {
                    const PiComp &comp = comps[compno];
                    if (!resume && resno >= comp.numresolutions) continue;
                    const PiRes &res = comp.res[resume ? resno : resno];
                    if (!resume) precno1 = res.pw * res.ph;
                    for (precno = resume ? precno + 1 : precno0;
                         precno < precno1; precno++) {
                        resume = false;
                        if (included()) return true;
                        if (bad) return false;
                    }
                    resume = false;
                }
                resume = false;
            }
            resume = false;
        }
        return false;
    }

    bool next_rlcp() {
        bool resume = !first;
        first = false;
        for (resno = resume ? resno : resno0; resno < resno1; resno++) {
            for (layno = resume ? layno : layno0; layno < layno1; layno++) {
                for (compno = resume ? compno : compno0; compno < compno1;
                     compno++) {
                    const PiComp &comp = comps[compno];
                    if (!resume && resno >= comp.numresolutions) continue;
                    const PiRes &res = comp.res[resno];
                    if (!resume) precno1 = res.pw * res.ph;
                    for (precno = resume ? precno + 1 : precno0;
                         precno < precno1; precno++) {
                        resume = false;
                        if (included()) return true;
                        if (bad) return false;
                    }
                    resume = false;
                }
                resume = false;
            }
            resume = false;
        }
        return false;
    }

    bool layers_from(bool &resume) {
        for (layno = resume ? layno + 1 : layno0; layno < layno1; layno++) {
            resume = false;
            if (included()) return true;
            if (bad) return false;
        }
        resume = false;
        return false;
    }

    bool next_rpcl() {
        bool resume = !first;
        if (first) {
            first = false;
            dx = dy = 0;
            for (const PiComp &c : comps) min_steps(c, dx, dy);
            if (dx == 0 || dy == 0) return false;
        }
        for (resno = resume ? resno : resno0; resno < resno1; resno++) {
            for (y = resume ? y : ty0; y < ty1; y += dy - (y % dy)) {
                for (x = resume ? x : tx0; x < tx1; x += dx - (x % dx)) {
                    for (compno = resume ? compno : compno0;
                         compno < compno1; compno++) {
                        if (!resume) {
                            const PiComp &comp = comps[compno];
                            if (resno >= comp.numresolutions) continue;
                            if (!position_precinct(comp)) continue;
                        }
                        if (layers_from(resume)) return true;
                        if (bad) return false;
                    }
                }
            }
        }
        return false;
    }

    bool next_pcrl() {
        bool resume = !first;
        if (first) {
            first = false;
            dx = dy = 0;
            for (const PiComp &c : comps) min_steps(c, dx, dy);
            if (dx == 0 || dy == 0) return false;
        }
        for (y = resume ? y : ty0; y < ty1; y += dy - (y % dy)) {
            for (x = resume ? x : tx0; x < tx1; x += dx - (x % dx)) {
                for (compno = resume ? compno : compno0; compno < compno1;
                     compno++) {
                    const PiComp &comp = comps[compno];
                    for (resno = resume ? resno : resno0;
                         resno < umin(resno1, comp.numresolutions); resno++) {
                        if (!resume && !position_precinct(comp)) continue;
                        if (layers_from(resume)) return true;
                        if (bad) return false;
                    }
                }
            }
        }
        return false;
    }

    bool next_cprl() {
        bool resume = !first;
        first = false;
        for (compno = resume ? compno : compno0; compno < compno1; compno++) {
            const PiComp &comp = comps[compno];
            if (!resume) {
                dx = dy = 0;
                min_steps(comp, dx, dy);
                if (dx == 0 || dy == 0) return false;
            }
            for (y = resume ? y : ty0; y < ty1; y += dy - (y % dy)) {
                for (x = resume ? x : tx0; x < tx1; x += dx - (x % dx)) {
                    for (resno = resume ? resno : resno0;
                         resno < umin(resno1, comp.numresolutions); resno++) {
                        if (!resume && !position_precinct(comp)) continue;
                        if (layers_from(resume)) return true;
                        if (bad) return false;
                    }
                }
            }
        }
        return false;
    }
};

// opj_pi_create_decode with opj_get_all_encoding_parameters
void create_pis(Decoder &j, u32 tileno, std::vector<Pi> &pis,
                std::vector<int16_t> &include) {
    Tcp &tcp = j.tcps[tileno];
    Image &image = j.image;
    u32 p = tileno % j.tw, q = tileno / j.tw;
    u32 l_tx0 = j.tx0 + p * j.tdx, l_ty0 = j.ty0 + q * j.tdy;
    Pi base;
    base.tx0 = umax(l_tx0, image.x0);
    base.tx1 = umin(uadds(l_tx0, j.tdx), image.x1);
    base.ty0 = umax(l_ty0, image.y0);
    base.ty1 = umin(uadds(l_ty0, j.tdy), image.y1);
    u32 max_prec = 0, max_res = 0;
    base.comps.resize(image.numcomps);
    for (u32 c = 0; c < image.numcomps; ++c) {
        const Tccp &tccp = tcp.tccps[c];
        const Comp &ic = image.comps[c];
        PiComp &pc = base.comps[c];
        pc.dx = ic.dx;
        pc.dy = ic.dy;
        pc.numresolutions = tccp.numresolutions;
        pc.res.resize(tccp.numresolutions);
        u32 tcx0 = uceildiv(base.tx0, ic.dx), tcy0 = uceildiv(base.ty0, ic.dy);
        u32 tcx1 = uceildiv(base.tx1, ic.dx), tcy1 = uceildiv(base.ty1, ic.dy);
        if (tccp.numresolutions > max_res) max_res = tccp.numresolutions;
        u32 level = tccp.numresolutions;
        for (u32 r = 0; r < tccp.numresolutions; ++r) {
            --level;
            u32 pdx = tccp.prcw[r], pdy = tccp.prch[r];
            u32 rx0 = uceildivpow2(tcx0, level), ry0 = uceildivpow2(tcy0, level);
            u32 rx1 = uceildivpow2(tcx1, level), ry1 = uceildivpow2(tcy1, level);
            u32 px0 = (rx0 >> pdx) << pdx, py0 = (ry0 >> pdy) << pdy;
            u32 px1 = uceildivpow2(rx1, pdx) << pdx;
            u32 py1 = uceildivpow2(ry1, pdy) << pdy;
            u32 pw = rx0 == rx1 ? 0 : (px1 - px0) >> pdx;
            u32 ph = ry0 == ry1 ? 0 : (py1 - py0) >> pdy;
            pc.res[r] = PiRes{pdx, pdy, pw, ph};
            if (pw * ph > max_prec) max_prec = pw * ph;
        }
    }
    base.step_p = 1;
    base.step_c = max_prec * base.step_p;
    base.step_r = image.numcomps * base.step_c;
    base.step_l = max_res * base.step_r;
    include.assign((u64)(tcp.numlayers + 1) * base.step_l, 0);
    u32 bound = tcp.numpocs + 1;
    pis.assign(bound, base);
    for (u32 i = 0; i < bound; ++i) {
        Pi &pi = pis[i];
        pi.include = &include;
        pi.first = true;
        pi.layno0 = 0;
        pi.precno0 = 0;
        pi.precno1 = max_prec;
        if (tcp.poc) {
            const Poc &c = tcp.pocs[i];
            pi.prg = c.prg;
            pi.resno0 = c.resno0;
            pi.compno0 = c.compno0;
            pi.resno1 = c.resno1;
            pi.compno1 = c.compno1;
            pi.layno1 = umin(c.layno1, tcp.numlayers);
        } else {
            pi.prg = tcp.prg;
            pi.resno0 = 0;
            pi.compno0 = 0;
            pi.resno1 = max_res;
            pi.compno1 = image.numcomps;
            pi.layno1 = tcp.numlayers;
        }
    }
}

// ---------------------------------------------------------------------------
// tier 2 (t2.c, bio.c, tgt.c)

struct Bio {
    const uint8_t *start, *end, *bp;
    u32 buf = 0, ct = 0;
    Bio(const uint8_t *p, u32 len) : start(p), end(p + len), bp(p) {}
    bool bytein() {
        buf = (buf << 8) & 0xffff;
        ct = buf == 0xff00 ? 7 : 8;
        if (bp >= end) return false;
        buf |= *bp++;
        return true;
    }
    u32 getbit() {
        if (ct == 0) bytein();
        ct--;
        return (buf >> ct) & 1;
    }
    u32 read(u32 n) {
        u32 v = 0;
        for (u32 i = n - 1; i < n; i--) v |= getbit() << i;
        return v;
    }
    bool inalign() {
        ct = 0;
        if ((buf & 0xff) == 0xff) {
            if (!bytein()) return false;
            ct = 0;
        }
        return true;
    }
    u32 numbytes() const { return (u32)(bp - start); }
};

u32 tgt_decode(Bio &bio, TagTree &tree, u32 leafno, i32 threshold) {
    i32 stk[64];
    int sp = 0;
    i32 node = (i32)leafno;
    while (tree.nodes[node].parent >= 0) {
        stk[sp++] = node;
        node = tree.nodes[node].parent;
    }
    i32 low = 0;
    for (;;) {
        TagTree::Node &n = tree.nodes[node];
        if (low > n.low) {
            n.low = low;
        } else {
            low = n.low;
        }
        while (low < threshold && low < n.value) {
            if (bio.read(1)) {
                n.value = low;
            } else {
                ++low;
            }
        }
        n.low = low;
        if (sp == 0) break;
        node = stk[--sp];
    }
    return tree.nodes[node].value < threshold ? 1 : 0;
}

u32 getnumpasses(Bio &bio) {
    u32 n;
    if (!bio.read(1)) return 1;
    if (!bio.read(1)) return 2;
    if ((n = bio.read(2)) != 3) return 3 + n;
    if ((n = bio.read(5)) != 31) return 6 + n;
    return 37 + bio.read(7);
}

u32 getcommacode(Bio &bio) {
    u32 n = 0;
    while (bio.read(1)) ++n;
    return n;
}

void init_seg(Cblk &cb, u32 index, u32 cblksty, bool first) {
    if (cb.segs.size() < index + 1) cb.segs.resize(index + 1);
    Seg &seg = cb.segs[index];
    seg = Seg();
    if (cblksty & 4) {
        seg.maxpasses = 1;
    } else if (cblksty & 1) {
        if (first) {
            seg.maxpasses = 10;
        } else {
            u32 prev = cb.segs[index - 1].maxpasses;
            seg.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
        }
    } else {
        seg.maxpasses = 109;
    }
}

bool read_packet(Decoder &j, Tile &tile, Tcp &tcp, Pi &pi,
                 const uint8_t *src, u32 max_length, u32 &data_read,
                 bool skip) {
    Res &res = tile.comps[pi.compno].resolutions[pi.resno];
    const uint8_t *cur = src;
    if (pi.layno == 0) {
        for (u32 b = 0; b < res.numbands; ++b) {
            Band &band = res.bands[b];
            if (band.empty()) continue;
            if (pi.precno >= band.precincts.size()) return false;
            Precinct &prc = band.precincts[pi.precno];
            prc.incl.reset();
            prc.imsb.reset();
            for (Cblk &cb : prc.cblks) {
                cb.numsegs = 0;
                cb.real_num_segs = 0;
            }
        }
    }
    if (tcp.csty & 2) {           // SOP
        if (max_length < 6) {
        } else if (cur[0] != 0xff || cur[1] != 0x91) {
        } else {
            cur += 6;
        }
    }
    const uint8_t *hstart;
    u32 hlen;
    const uint8_t *hdr;
    u64 *ppos = nullptr;
    if (j.ppm) {
        hstart = j.ppm_buffer.data() + j.ppm_pos;
        hlen = (u32)(j.ppm_buffer.size() - j.ppm_pos);
        ppos = &j.ppm_pos;
    } else if (tcp.ppt) {
        hstart = tcp.ppt_buffer.data() + tcp.ppt_pos;
        hlen = (u32)(tcp.ppt_buffer.size() - tcp.ppt_pos);
        ppos = &tcp.ppt_pos;
    } else {
        hstart = cur;
        hlen = (u32)(src + max_length - cur);
    }
    hdr = hstart;
    Bio bio(hdr, hlen);
    u32 present = bio.read(1);
    bool data_present = true;
    const u32 cblksty = tcp.tccps[pi.compno].cblksty;
    if (!present) {
        bio.inalign();
        hdr += bio.numbytes();
        data_present = false;
    } else {
        for (u32 b = 0; b < res.numbands; ++b) {
            Band &band = res.bands[b];
            if (band.empty()) continue;
            Precinct &prc = band.precincts[pi.precno];
            u32 ncb = prc.cw * prc.ch;
            for (u32 k = 0; k < ncb; ++k) {
                Cblk &cb = prc.cblks[k];
                u32 included;
                if (!cb.numsegs) {
                    included = tgt_decode(bio, prc.incl, k, (i32)pi.layno + 1);
                } else {
                    included = bio.read(1);
                }
                if (!included) {
                    cb.numnewpasses = 0;
                    continue;
                }
                if (!cb.numsegs) {
                    u32 i = 0;
                    while (!tgt_decode(bio, prc.imsb, k, (i32)i)) ++i;
                    cb.numbps = (u32)band.numbps + 1 - i;
                    cb.numlenbits = 3;
                }
                cb.numnewpasses = getnumpasses(bio);
                u32 increment = getcommacode(bio);
                cb.numlenbits += increment;
                u32 segno = 0;
                if (!cb.numsegs) {
                    init_seg(cb, segno, cblksty, true);
                } else {
                    segno = cb.numsegs - 1;
                    if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
                        ++segno;
                        init_seg(cb, segno, cblksty, false);
                    }
                }
                i32 n = (i32)cb.numnewpasses;
                do {
                    Seg &seg = cb.segs[segno];
                    seg.numnewpasses = (u32)imin(
                        (i32)(seg.maxpasses - seg.numpasses), n);
                    u32 bits = cb.numlenbits + floorlog2(seg.numnewpasses);
                    if (bits > 32) return false;
                    seg.newlen = bio.read(bits);
                    n -= (i32)seg.numnewpasses;
                    if (n > 0) {
                        ++segno;
                        init_seg(cb, segno, cblksty, false);
                    }
                } while (n > 0);
            }
        }
        if (!bio.inalign()) return false;
        hdr += bio.numbytes();
    }
    if (tcp.csty & 4) {           // EPH: a missing one fails the decode
        if (hlen - (u32)(hdr - hstart) < 2u ||
            hdr[0] != 0xff || hdr[1] != 0x92)
            return false;
        hdr += 2;
    }
    u32 header_length = (u32)(hdr - hstart);
    if (ppos) {
        *ppos += header_length;
    } else {
        cur += header_length;
    }
    if (!data_present) {
        data_read = (u32)(cur - src);
        return true;
    }
    // the packet's data (opj_t2_read_packet_data, opj_t2_skip_packet_data)
    u32 remaining = max_length - (u32)(cur - src);
    u32 used = 0;
    for (u32 b = 0; b < res.numbands; ++b) {
        Band &band = res.bands[b];
        if (band.x1 - band.x0 == 0 || band.y1 - band.y0 == 0) continue;
        Precinct &prc = band.precincts[pi.precno];
        for (Cblk &cb : prc.cblks) {
            if (!cb.numnewpasses) continue;
            u32 segi;
            if (!cb.numsegs) {
                segi = 0;
                ++cb.numsegs;
            } else {
                segi = cb.numsegs - 1;
                if (cb.segs[segi].numpasses == cb.segs[segi].maxpasses) {
                    ++segi;
                    ++cb.numsegs;
                }
            }
            do {
                Seg &seg = cb.segs[segi];
                if ((u64)used + seg.newlen > remaining) return false;
                if (!skip) {
                    cb.chunks.push_back(Chunk{cur + used, seg.newlen});
                    seg.len += seg.newlen;
                }
                used += seg.newlen;
                seg.numpasses += seg.numnewpasses;
                cb.numnewpasses -= seg.numnewpasses;
                if (!skip) seg.real_num_passes = seg.numpasses;
                if (cb.numnewpasses > 0) {
                    ++segi;
                    ++cb.numsegs;
                }
            } while (cb.numnewpasses > 0);
            if (!skip) cb.real_num_segs = cb.numsegs;
        }
    }
    data_read = (u32)(cur - src) + used;
    return true;
}

bool t2_decode(Decoder &j, u32 tileno, Tile &tile) {
    Tcp &tcp = j.tcps[tileno];
    Image &image = j.image;
    std::vector<Pi> pis;
    std::vector<int16_t> include;
    create_pis(j, tileno, pis, include);
    const uint8_t *cur = tcp.data.data();
    u32 max_len = (u32)tcp.data.size();
    for (u32 pino = 0; pino <= tcp.numpocs; ++pino) {
        Pi &pi = pis[pino];
        if (pi.prg == 0xffffffffu) return false;   // COD's unknown order;
                                                   // a POC's yields none
        std::vector<bool> first_failed(image.numcomps, true);
        while (pi.next()) {
            TileComp &tc = tile.comps[pi.compno];
            Res &res = tc.resolutions[pi.resno];
            bool skip = true;
            if (pi.layno >= tcp.numlayers ||
                pi.resno >= tc.minimum_num_resolutions) {
                skip = true;
            } else {
                for (u32 b = 0; b < res.numbands; ++b) {
                    Band &band = res.bands[b];
                    if (pi.precno >= band.precincts.size()) continue;
                    Precinct &prc = band.precincts[pi.precno];
                    // opj_tcd_is_subband_area_of_interest, the area the
                    // whole tile
                    u32 margin = tcp.tccps[pi.compno].qmfbid == 1 ? 2 : 3;
                    u32 tcx0 = (u32)tc.x0, tcy0 = (u32)tc.y0;
                    u32 tcx1 = (u32)tc.x1, tcy1 = (u32)tc.y1;
                    u32 nb = pi.resno == 0 ? tc.numresolutions - 1
                                           : tc.numresolutions - pi.resno;
                    u32 x0b = band.bandno & 1, y0b = band.bandno >> 1;
                    u32 tbx0, tby0, tbx1, tby1;
                    if (nb == 0) {
                        tbx0 = tcx0; tby0 = tcy0; tbx1 = tcx1; tby1 = tcy1;
                    } else {
                        u32 h = 1u << (nb - 1);
                        tbx0 = tcx0 <= h * x0b ? 0 : uceildivpow2(tcx0 - h * x0b, nb);
                        tby0 = tcy0 <= h * y0b ? 0 : uceildivpow2(tcy0 - h * y0b, nb);
                        tbx1 = tcx1 <= h * x0b ? 0 : uceildivpow2(tcx1 - h * x0b, nb);
                        tby1 = tcy1 <= h * y0b ? 0 : uceildivpow2(tcy1 - h * y0b, nb);
                    }
                    tbx0 = tbx0 < margin ? 0 : tbx0 - margin;
                    tby0 = tby0 < margin ? 0 : tby0 - margin;
                    tbx1 = uadds(tbx1, margin);
                    tby1 = uadds(tby1, margin);
                    if ((u32)prc.x0 < tbx1 && (u32)prc.y0 < tby1 &&
                        (u32)prc.x1 > tbx0 && (u32)prc.y1 > tby0) {
                        skip = false;
                        break;
                    }
                }
            }
            u32 nread = 0;
            if (!skip) first_failed[pi.compno] = false;
            if (!read_packet(j, tile, tcp, pi, cur, max_len, nread, skip))
                return false;
            Comp &ic = image.comps[pi.compno];
            if (!skip) ic.resno_decoded = umax(pi.resno, ic.resno_decoded);
            if (first_failed[pi.compno] && ic.resno_decoded == 0)
                ic.resno_decoded = tc.minimum_num_resolutions - 1;
            cur += nread;
            max_len -= nread;
        }
    }
    return true;
}

// ---------------------------------------------------------------------------
// tier 1 (t1.c, mqc.c): the MQ decoder and the three coding passes

struct MqState {
    u32 qeval;
    u32 nmps, nlps, sw;
};

// ISO/IEC 15444-1 Table C.2
const MqState MQ_TABLE[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0ac1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1c01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1c01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0ac1, 31, 28, 0}, {0x09c1, 32, 29, 0}, {0x08a1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02a1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18,
       NUM_CTX = 19 };

struct Mq {
    // the segment's bytes, then OpenJPEG's synthetic 0xFF 0xFF
    std::vector<uint8_t> buf;
    size_t bp = 0;
    u32 a = 0, c = 0, ct = 0;
    u32 state[NUM_CTX];
    u32 mps[NUM_CTX];

    void reset_states() {
        for (int i = 0; i < NUM_CTX; ++i) {
            state[i] = 0;
            mps[i] = 0;
        }
        state[CTX_UNI] = 46;
        state[CTX_AGG] = 3;
        state[CTX_ZC] = 4;
    }
    void load(const uint8_t *p, u32 len) {
        buf.assign(p, p + len);
        buf.push_back(0xff);
        buf.push_back(0xff);
        bp = 0;
    }
    void bytein() {
        u32 l_c = buf[bp + 1];
        if (buf[bp] == 0xff) {
            if (l_c > 0x8f) {
                c += 0xff00;
                ct = 8;
            } else {
                bp++;
                c += l_c << 9;
                ct = 7;
            }
        } else {
            bp++;
            c += l_c << 8;
            ct = 8;
        }
    }
    void init(const uint8_t *p, u32 len) {
        load(p, len);
        c = len == 0 ? 0xffu << 16 : (u32)buf[0] << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    void raw_init(const uint8_t *p, u32 len) {
        load(p, len);
        c = 0;
        ct = 0;
    }
    void renorm() {
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            ct--;
        } while (a < 0x8000);
    }
    u32 decode(int cx) {
        const MqState &st = MQ_TABLE[state[cx]];
        u32 d;
        a -= st.qeval;
        if ((c >> 16) < st.qeval) {
            // LPS exchange
            if (a < st.qeval) {
                a = st.qeval;
                d = mps[cx];
                state[cx] = st.nmps;
            } else {
                a = st.qeval;
                d = !mps[cx];
                if (st.sw) mps[cx] = !mps[cx];
                state[cx] = st.nlps;
            }
            renorm();
        } else {
            c -= st.qeval << 16;
            if ((a & 0x8000) == 0) {
                // MPS exchange
                if (a < st.qeval) {
                    d = !mps[cx];
                    if (st.sw) mps[cx] = !mps[cx];
                    state[cx] = st.nlps;
                } else {
                    d = mps[cx];
                    state[cx] = st.nmps;
                }
                renorm();
            } else {
                d = mps[cx];
            }
        }
        return d;
    }
    u32 raw_decode() {
        if (ct == 0) {
            if (c == 0xff) {
                if (buf[bp] > 0x8f) {
                    c = 0xff;
                    ct = 8;
                } else {
                    c = buf[bp];
                    bp++;
                    ct = 7;
                }
            } else {
                c = buf[bp];
                bp++;
                ct = 8;
            }
        }
        ct--;
        return (c >> ct) & 1u;
    }
};

// a coefficient's flags: its own state, then which of its eight
// neighbours are significant and the signs of the four nearest
enum : uint16_t {
    F_SIG = 1, F_PI = 2, F_MU = 4, F_CHI = 8,
    F_N = 1 << 4, F_S = 1 << 5, F_W = 1 << 6, F_E = 1 << 7,
    F_NW = 1 << 8, F_NE = 1 << 9, F_SW = 1 << 10, F_SE = 1 << 11,
    F_NBRS = 0xff0,
    F_CHI_N = 1 << 12, F_CHI_S = 1 << 13, F_CHI_W = 1 << 14,
    F_CHI_E = 1 << 15
};

// the zero coding contexts (Table D.1) by the eight neighbour bits, for
// LL and LH, for HL (the horizontal and vertical counts swapped) and HH;
// the sign contexts and xor bits (Table D.3) by the four neighbours'
// significance and signs
struct T1Tables {
    uint8_t zc[3][256];
    uint8_t sc[256], spb[256];
    T1Tables() {
        for (int f = 0; f < 256; ++f) {
            int n = f & 1, s = (f >> 1) & 1, w = (f >> 2) & 1, e = (f >> 3) & 1;
            int d = ((f >> 4) & 1) + ((f >> 5) & 1) + ((f >> 6) & 1) +
                    ((f >> 7) & 1);
            for (int o = 0; o < 3; ++o) {
                int h = w + e, v = n + s, c;
                if (o == 2) {
                    int hv = h + v;
                    if (!d) c = !hv ? 0 : hv == 1 ? 1 : 2;
                    else if (d == 1) c = !hv ? 3 : hv == 1 ? 4 : 5;
                    else if (d == 2) c = !hv ? 6 : 7;
                    else c = 8;
                } else {
                    if (o == 1) {
                        int t = h;
                        h = v;
                        v = t;
                    }
                    if (!h) {
                        if (!v) c = !d ? 0 : d == 1 ? 1 : 2;
                        else c = v == 1 ? 3 : 4;
                    } else if (h == 1) {
                        c = !v ? (!d ? 5 : 6) : 7;
                    } else {
                        c = 8;
                    }
                }
                zc[o][f] = (uint8_t)(CTX_ZC + c);
            }
            // f: N, S, W, E significance in bits 0-3, their signs 4-7
            auto part = [&](int sig, int neg, int &pos, int &ng) {
                if (sig) { if (neg) ng = 1; else pos = 1; }
            };
            int hp = 0, hn = 0, vp = 0, vn = 0;
            part(e, (f >> 7) & 1, hp, hn);
            part(w, (f >> 6) & 1, hp, hn);
            part(n, (f >> 4) & 1, vp, vn);
            part(s, (f >> 5) & 1, vp, vn);
            int hc = hp - hn, vc = vp - vn;
            spb[f] = (uint8_t)((!hc && !vc) ? 0 : !(hc > 0 || (!hc && vc > 0)));
            if (hc < 0) {
                hc = -hc;
                vc = -vc;
            }
            int c = !hc ? (vc ? 1 : 0) : (vc == -1 ? 2 : !vc ? 3 : 4);
            sc[f] = (uint8_t)(CTX_SC + c);
        }
    }
};

const T1Tables T1_TABLES;

struct T1 {
    u32 w = 0, h = 0;
    std::vector<i32> data;
    std::vector<uint16_t> flags;     // with a border of one
    u32 stride = 0;
    bool vsc = false;
    const uint8_t *zc = nullptr;
    Mq mq;

    void alloc(u32 cw, u32 ch, u32 bandno) {
        w = cw;
        h = ch;
        stride = w + 2;
        data.assign((size_t)w * h, 0);
        flags.assign((size_t)stride * (h + 2), 0);
        zc = T1_TABLES.zc[bandno == 3 ? 2 : bandno == 1 ? 1 : 0];
    }
    size_t at(u32 x, u32 y) const { return (size_t)(y + 1) * stride + x + 1; }
    int ctx_zc(uint16_t f) const {
        // the neighbour bits in the tables' order: N, S, W, E, then the
        // diagonals
        return zc[(f >> 4) & 0xff];
    }
    // (x, y) significant: its neighbours learn it; vertically causal, a
    // stripe's last row never learns of the next stripe's first
    void set_significant(u32 x, u32 y, u32 negative, i32 value) {
        data[(size_t)y * w + x] = negative ? -value : value;
        size_t i = at(x, y);
        uint16_t *f = flags.data();
        f[i] |= F_SIG | (negative ? F_CHI : 0);
        f[i - 1] |= F_E | (negative ? F_CHI_E : 0);
        f[i + 1] |= F_W | (negative ? F_CHI_W : 0);
        if (!(vsc && (y & 3) == 0)) {
            f[i - stride] |= F_S | (negative ? F_CHI_S : 0);
            f[i - stride - 1] |= F_SE;
            f[i - stride + 1] |= F_SW;
        }
        f[i + stride] |= F_N | (negative ? F_CHI_N : 0);
        f[i + stride - 1] |= F_NE;
        f[i + stride + 1] |= F_NW;
    }
    void decode_sign(u32 x, u32 y, uint16_t f, i32 oneplushalf) {
        u32 idx = ((f >> 4) & 0xf) | ((f >> 8) & 0xf0);
        u32 v = mq.decode(T1_TABLES.sc[idx]) ^ T1_TABLES.spb[idx];
        set_significant(x, y, v, oneplushalf);
    }

    void sigpass(int bpno_plus_one, bool raw) {
        i32 one = 1 << bpno_plus_one, half = one >> 1;
        i32 oneplushalf = one | half;
        for (u32 k = 0; k < h; k += 4)
            for (u32 x = 0; x < w; ++x)
                for (u32 y = k; y < k + 4 && y < h; ++y) {
                    size_t i = at(x, y);
                    uint16_t f = flags[i];
                    if ((f & (F_SIG | F_PI)) || !(f & F_NBRS)) continue;
                    if (raw) {
                        if (mq.raw_decode()) {
                            u32 v = mq.raw_decode();
                            set_significant(x, y, v, oneplushalf);
                        }
                    } else if (mq.decode(ctx_zc(f))) {
                        decode_sign(x, y, f, oneplushalf);
                    }
                    flags[i] |= F_PI;
                }
    }

    void refpass(int bpno_plus_one, bool raw) {
        i32 one = 1 << bpno_plus_one, poshalf = one >> 1;
        for (u32 k = 0; k < h; k += 4)
            for (u32 x = 0; x < w; ++x)
                for (u32 y = k; y < k + 4 && y < h; ++y) {
                    size_t i = at(x, y);
                    uint16_t f = flags[i];
                    if ((f & (F_SIG | F_PI)) != F_SIG) continue;
                    u32 v;
                    if (raw) {
                        v = mq.raw_decode();
                    } else {
                        int cx = (f & F_MU) ? CTX_MAG + 2
                                 : (f & F_NBRS) ? CTX_MAG + 1 : CTX_MAG;
                        v = mq.decode(cx);
                    }
                    i32 &d = data[(size_t)y * w + x];
                    d += (v ^ (u32)(d < 0)) ? poshalf : -poshalf;
                    flags[i] |= F_MU;
                }
    }

    void clnpass(int bpno_plus_one, u32 cblksty) {
        i32 one = 1 << bpno_plus_one, half = one >> 1;
        i32 oneplushalf = one | half;
        u32 k = 0;
        const uint16_t busy = F_SIG | F_PI | F_NBRS;
        for (; k < (h & ~3u); k += 4)
            for (u32 x = 0; x < w; ++x) {
                size_t i0 = at(x, k);
                if (!(flags[i0] & busy) && !(flags[i0 + stride] & busy) &&
                    !(flags[i0 + 2 * stride] & busy) &&
                    !(flags[i0 + 3 * stride] & busy)) {
                    if (!mq.decode(CTX_AGG)) continue;   // PI are all 0
                    u32 runlen = mq.decode(CTX_UNI);
                    runlen = (runlen << 1) | mq.decode(CTX_UNI);
                    u32 y = k + runlen;
                    decode_sign(x, y, flags[at(x, y)], oneplushalf);
                    for (++y; y < k + 4; ++y) {
                        uint16_t f = flags[at(x, y)];
                        if (mq.decode(ctx_zc(f)))
                            decode_sign(x, y, f, oneplushalf);
                    }
                } else {
                    for (u32 y = k; y < k + 4; ++y) {
                        uint16_t f = flags[at(x, y)];
                        if (f & (F_SIG | F_PI)) continue;
                        if (mq.decode(ctx_zc(f)))
                            decode_sign(x, y, f, oneplushalf);
                    }
                }
                for (u32 y = 0; y < 4; ++y) flags[i0 + y * stride] &= ~F_PI;
            }
        if (k < h)
            for (u32 x = 0; x < w; ++x) {
                for (u32 y = k; y < h; ++y) {
                    uint16_t f = flags[at(x, y)];
                    if (f & (F_SIG | F_PI)) continue;
                    if (mq.decode(ctx_zc(f)))
                        decode_sign(x, y, f, oneplushalf);
                }
                for (u32 y = k; y < h; ++y) flags[at(x, y)] &= ~F_PI;
            }
        if (cblksty & 0x20) {      // segmentation symbol, read and ignored
            for (int i = 0; i < 4; ++i) mq.decode(CTX_UNI);
        }
    }
};

// opj_t1_decode_cblk; false where OpenJPEG's fails
bool decode_cblk(T1 &t1, Cblk &cb, u32 bandno, u32 roishift, u32 cblksty) {
    t1.alloc((u32)(cb.x1 - cb.x0), (u32)(cb.y1 - cb.y0), bandno);
    t1.vsc = (cblksty & 8) != 0;
    int bpno_plus_one = (int)(roishift + cb.numbps);
    if (bpno_plus_one >= 31) return false;
    u32 passtype = 2;
    t1.mq.reset_states();
    std::vector<uint8_t> all;
    for (const Chunk &c : cb.chunks) all.insert(all.end(), c.data, c.data + c.len);
    if (cb.chunks.empty()) return true;
    u32 index = 0;
    for (u32 segno = 0; segno < cb.real_num_segs; ++segno) {
        Seg &seg = cb.segs[segno];
        bool raw = bpno_plus_one <= (int)cb.numbps - 4 && passtype < 2 &&
                   (cblksty & 1);
        if (raw) {
            t1.mq.raw_init(all.data() + index, seg.len);
        } else {
            t1.mq.init(all.data() + index, seg.len);
        }
        index += seg.len;
        for (u32 passno = 0; passno < seg.real_num_passes && bpno_plus_one >= 1;
             ++passno) {
            switch (passtype) {
            case 0: t1.sigpass(bpno_plus_one, raw); break;
            case 1: t1.refpass(bpno_plus_one, raw); break;
            case 2: t1.clnpass(bpno_plus_one, cblksty); break;
            }
            if ((cblksty & 2) && !raw) t1.mq.reset_states();
            if (++passtype == 3) {
                passtype = 0;
                bpno_plus_one--;
            }
        }
    }
    return true;
}

// opj_tcd_t1_decode: every code-block into the tile's buffer (as integers
// halved for the 5/3, as floats times half the step for the 9/7)
bool t1_decode(Decoder &j, u32 tileno, Tile &tile) {
    Tcp &tcp = j.tcps[tileno];
    T1 t1;
    for (u32 compno = 0; compno < tile.comps.size(); ++compno) {
        TileComp &tc = tile.comps[compno];
        Tccp &tccp = tcp.tccps[compno];
        u32 tile_w = (u32)(tc.x1 - tc.x0);
        tc.data.assign((size_t)tile_w * (u32)(tc.y1 - tc.y0), 0);
        for (u32 resno = 0; resno < tc.minimum_num_resolutions; ++resno) {
            Res &res = tc.resolutions[resno];
            for (u32 b = 0; b < res.numbands; ++b) {
                Band &band = res.bands[b];
                for (Precinct &prc : band.precincts) {
                    for (Cblk &cb : prc.cblks) {
                        if (!decode_cblk(t1, cb, band.bandno,
                                         (u32)tccp.roishift, tccp.cblksty))
                            return false;
                        u32 cw = (u32)(cb.x1 - cb.x0), ch = (u32)(cb.y1 - cb.y0);
                        i32 x = cb.x0 - band.x0, y = cb.y0 - band.y0;
                        if (band.bandno & 1) {
                            Res &pres = tc.resolutions[resno - 1];
                            x += pres.x1 - pres.x0;
                        }
                        if (band.bandno & 2) {
                            Res &pres = tc.resolutions[resno - 1];
                            y += pres.y1 - pres.y0;
                        }
                        i32 *d = t1.data.data();
                        if (tccp.roishift) {
                            if (tccp.roishift >= 31) {
                                for (size_t i = 0; i < (size_t)cw * ch; ++i)
                                    d[i] = 0;
                            } else {
                                i32 thresh = 1 << tccp.roishift;
                                for (size_t i = 0; i < (size_t)cw * ch; ++i) {
                                    i32 val = d[i];
                                    i32 mag = val < 0 ? -val : val;
                                    if (mag >= thresh) {
                                        mag >>= tccp.roishift;
                                        d[i] = val < 0 ? -mag : mag;
                                    }
                                }
                            }
                        }
                        i32 *out = tc.data.data() + (size_t)y * tile_w + x;
                        if (tccp.qmfbid == 1) {
                            for (u32 r = 0; r < ch; ++r)
                                for (u32 c = 0; c < cw; ++c)
                                    out[(size_t)r * tile_w + c] =
                                        d[(size_t)r * cw + c] / 2;
                        } else {
                            const float stepsize = 0.5f * band.stepsize;
                            for (u32 r = 0; r < ch; ++r)
                                for (u32 c = 0; c < cw; ++c) {
                                    float f = (float)d[(size_t)r * cw + c] *
                                              stepsize;
                                    memcpy(&out[(size_t)r * tile_w + c], &f, 4);
                                }
                        }
                    }
                }
            }
        }
    }
    return true;
}

// ---------------------------------------------------------------------------
// the inverse DWT (dwt.c)

// the 5/3 on one line of len samples, sn low then dn high, in place
void idwt53_line(i32 *line, size_t stride, i32 sn, i32 dn, int cas,
                 std::vector<i32> &X) {
    i32 len = sn + dn;
    if (cas == 0) {
        if (len <= 1) return;
    } else {
        if (len == 1) {
            line[0] /= 2;
            return;
        }
    }
    // interleave: X[cas + 2i] = low i, X[1 - cas + 2i] = high i
    X.resize(len);
    for (i32 i = 0; i < sn; ++i) X[cas + 2 * i] = line[(size_t)i * stride];
    for (i32 i = 0; i < dn; ++i) X[1 - cas + 2 * i] = line[(size_t)(sn + i) * stride];
    auto at = [&](i32 i) {
        // symmetric extension
        while (i < 0 || i >= len) {
            if (i < 0) i = -i;
            if (i >= len) i = 2 * (len - 1) - i;
        }
        return X[i];
    };
    // even positions (the low samples for cas 0) first
    for (i32 i = cas; i < len; i += 2)
        X[i] = X[i] - ((at(i - 1) + at(i + 1) + 2) >> 2);
    for (i32 i = 1 - cas; i < len; i += 2)
        X[i] = X[i] + ((at(i - 1) + at(i + 1)) >> 1);
    for (i32 i = 0; i < len; ++i) line[(size_t)i * stride] = X[i];
}

const float DWT_ALPHA = 1.586134342f;
const float DWT_BETA = 0.052980118f;
const float DWT_GAMMA = -0.882911075f;
const float DWT_DELTA = -0.443506852f;
const float DWT_K = 1.230174105f;
const float DWT_TWO_INVK = 1.625732422f;

// opj_v8dwt_decode on one line of floats (each lane of OpenJPEG's vectors
// computes this)
void idwt97_line(float *line, size_t stride, i32 sn, i32 dn, int cas,
                 std::vector<float> &w) {
    i32 len = sn + dn;
    if (cas == 0) {
        if (!(dn > 0 || sn > 1)) return;
    } else {
        if (!(sn > 0 || dn > 1)) return;
    }
    w.resize(len);
    for (i32 i = 0; i < sn; ++i) w[cas + 2 * i] = line[(size_t)i * stride];
    for (i32 i = 0; i < dn; ++i) w[1 - cas + 2 * i] = line[(size_t)(sn + i) * stride];
    i32 a = cas == 0 ? 0 : 1, b = cas == 0 ? 1 : 0;
    for (i32 i = 0; i < sn; ++i) w[a + 2 * i] *= DWT_K;
    for (i32 i = 0; i < dn; ++i) w[b + 2 * i] *= DWT_TWO_INVK;
    // step2(l, w, end, m, c): for i < min(end, m): W[2i - 1] += (L + W[2i])
    // * c, L the previous W[2i - 2] or l[0] at i = 0; then where m < end,
    // W[2m - 1] += W[2m - 2] * (c + c); W = w + 1 + offset
    auto step2 = [&](i32 lo, i32 wo, i32 end, i32 m, float c) {
        i32 imax = end < m ? end : m;
        if (imax < 0) imax = 0;
        for (i32 i = 0; i < imax; ++i) {
            i32 t = wo + 2 * i - 1;
            float left = i == 0 ? w[lo] : w[wo + 2 * i - 2];
            w[t] = w[t] + (left + w[wo + 2 * i]) * c;
        }
        if (m < end) {
            i32 t = wo + 2 * m - 1;
            float c2 = c + c;
            w[t] = w[t] + w[m == 0 ? lo : wo + 2 * m - 2] * c2;
        }
    };
    // m is unsigned in OpenJPEG: a negative one never bounds the loop
    auto um = [](i32 x, i32 y) { i32 m = imin(x, y); return m < 0 ? 0x7fffffff : m; };
    step2(b, a + 1, sn, um(sn, dn - a), DWT_DELTA);
    step2(a, b + 1, dn, um(dn, sn - b), DWT_GAMMA);
    step2(b, a + 1, sn, um(sn, dn - a), DWT_BETA);
    step2(a, b + 1, dn, um(dn, sn - b), DWT_ALPHA);
    for (i32 i = 0; i < len; ++i) line[(size_t)i * stride] = w[i];
}

void dwt_decode(TileComp &tc, u32 numres, bool reversible) {
    if (numres <= 1) return;
    Res *tr = tc.resolutions.data();
    u32 rw = (u32)(tr->x1 - tr->x0), rh = (u32)(tr->y1 - tr->y0);
    Res &full = tc.resolutions[tc.minimum_num_resolutions - 1];
    size_t w = (size_t)(full.x1 - full.x0);
    std::vector<i32> tmp;
    std::vector<float> ftmp;
    while (--numres) {
        ++tr;
        i32 hsn = (i32)rw, vsn = (i32)rh;
        rw = (u32)(tr->x1 - tr->x0);
        rh = (u32)(tr->y1 - tr->y0);
        i32 hdn = (i32)(rw - (u32)hsn);
        int hcas = tr->x0 % 2;
        i32 vdn = (i32)(rh - (u32)vsn);
        int vcas = tr->y0 % 2;
        i32 *d = tc.data.data();
        if (reversible) {
            for (u32 j = 0; j < rh; ++j)
                idwt53_line(d + j * w, 1, hsn, hdn, hcas, tmp);
            for (u32 j = 0; j < rw; ++j)
                idwt53_line(d + j, w, vsn, vdn, vcas, tmp);
        } else {
            float *f = reinterpret_cast<float *>(d);
            for (u32 j = 0; j < rh; ++j)
                idwt97_line(f + j * w, 1, hsn, hdn, hcas, ftmp);
            for (u32 j = 0; j < rw; ++j)
                idwt97_line(f + j, w, vsn, vdn, vcas, ftmp);
        }
    }
}

// ---------------------------------------------------------------------------
// opj_tcd_decode_tile's last steps and opj_tcd_update_tile_data

bool decode_tile_data(Decoder &j, u32 tileno, Tile &tile,
                      std::vector<uint8_t> &buf) {
    Tcp &tcp = j.tcps[tileno];
    Image &image = j.image;
    if (!t2_decode(j, tileno, tile)) return false;
    if (!t1_decode(j, tileno, tile)) return false;
    for (u32 c = 0; c < image.numcomps; ++c)
        dwt_decode(tile.comps[c], image.comps[c].resno_decoded + 1,
                   tcp.tccps[c].qmfbid == 1);
    // the inverse RCT or ICT on the first three components
    if (tcp.mct) {
        TileComp &c0 = tile.comps[0];
        Res &r0 = c0.resolutions[c0.minimum_num_resolutions - 1];
        size_t n = (size_t)(r0.x1 - r0.x0) * (size_t)(r0.y1 - r0.y0);
        if (tile.comps.size() >= 3) {
            TileComp &c1 = tile.comps[1], &c2 = tile.comps[2];
            if (c0.minimum_num_resolutions != c1.minimum_num_resolutions ||
                c0.minimum_num_resolutions != c2.minimum_num_resolutions)
                return false;
            Res &r1 = c1.resolutions[c0.minimum_num_resolutions - 1];
            Res &r2 = c2.resolutions[c0.minimum_num_resolutions - 1];
            if (image.comps[0].resno_decoded != image.comps[1].resno_decoded ||
                image.comps[0].resno_decoded != image.comps[2].resno_decoded ||
                (size_t)(r1.x1 - r1.x0) * (size_t)(r1.y1 - r1.y0) != n ||
                (size_t)(r2.x1 - r2.x0) * (size_t)(r2.y1 - r2.y0) != n)
                return false;
            if (tcp.tccps[0].qmfbid == 1) {
                i32 *y = c0.data.data(), *u = c1.data.data(),
                    *v = c2.data.data();
                for (size_t i = 0; i < n; ++i) {
                    i32 g = y[i] - ((u[i] + v[i]) >> 2);
                    i32 r = v[i] + g, b = u[i] + g;
                    y[i] = r;
                    u[i] = g;
                    v[i] = b;
                }
            } else {
                float *y = reinterpret_cast<float *>(c0.data.data());
                float *u = reinterpret_cast<float *>(c1.data.data());
                float *v = reinterpret_cast<float *>(c2.data.data());
                for (size_t i = 0; i < n; ++i) {
                    float yy = y[i], uu = u[i], vv = v[i];
                    float r = yy + (vv * 1.402f);
                    float g = yy - (uu * 0.34413f) - (vv * 0.71414f);
                    float b = yy + (uu * 1.772f);
                    y[i] = r;
                    u[i] = g;
                    v[i] = b;
                }
            }
        }
    }
    // the DC level shift and the clamp to the component's precision
    for (u32 c = 0; c < image.numcomps; ++c) {
        TileComp &tc = tile.comps[c];
        Comp &ic = image.comps[c];
        Res &res = tc.resolutions[ic.resno_decoded];
        u32 width = (u32)(res.x1 - res.x0), height = (u32)(res.y1 - res.y0);
        Res &full = tc.resolutions[tc.minimum_num_resolutions - 1];
        u32 stride = (u32)(full.x1 - full.x0);
        i32 lo, hi;
        if (ic.sgnd) {
            lo = -(1 << (ic.prec - 1));
            hi = (1 << (ic.prec - 1)) - 1;
        } else {
            lo = 0;
            hi = (i32)((1u << ic.prec) - 1);
        }
        i32 shift = ic.sgnd ? 0 : (i32)(1u << (ic.prec - 1));
        for (u32 y = 0; y < height; ++y) {
            i32 *p = tc.data.data() + (size_t)y * stride;
            for (u32 x = 0; x < width; ++x) {
                if (tcp.tccps[c].qmfbid == 1) {
                    i64 v = (i64)(i32)((u32)p[x] + (u32)shift);
                    p[x] = (i32)(v < lo ? lo : v > hi ? hi : v);
                } else {
                    float f;
                    memcpy(&f, &p[x], 4);
                    if (f > (float)2147483647) {
                        p[x] = hi;
                    } else if (f < -2147483648.0f) {
                        p[x] = lo;
                    } else {
                        i64 v = (i64)lrintf(f) + shift;
                        p[x] = (i32)(v < lo ? lo : v > hi ? hi : v);
                    }
                }
            }
        }
    }
    // opj_tcd_update_tile_data into Pillow's buffer
    size_t at = 0;
    for (u32 c = 0; c < image.numcomps; ++c) {
        TileComp &tc = tile.comps[c];
        Comp &ic = image.comps[c];
        u32 size_comp = (ic.prec >> 3) + ((ic.prec & 7) ? 1 : 0);
        if (size_comp == 3) size_comp = 4;
        Res &res = tc.resolutions[ic.resno_decoded];
        u32 width = (u32)(res.x1 - res.x0), height = (u32)(res.y1 - res.y0);
        Res &full = tc.resolutions[tc.minimum_num_resolutions - 1];
        u32 stride = (u32)(full.x1 - full.x0);
        for (u32 y = 0; y < height; ++y) {
            const i32 *p = tc.data.data() + (size_t)y * stride;
            for (u32 x = 0; x < width; ++x) {
                u32 v = (u32)p[x];
                if (at + size_comp > buf.size()) return false;
                if (size_comp == 1) {
                    buf[at] = (uint8_t)v;
                } else if (size_comp == 2) {
                    uint16_t s16 = (uint16_t)v;
                    memcpy(&buf[at], &s16, 2);
                } else {
                    memcpy(&buf[at], &v, 4);
                }
                at += size_comp;
            }
        }
    }
    return true;
}

// the tile's size in OpenJPEG's buffer (opj_tcd_get_decoded_tile_size):
// every component at its full resolution
u64 decoded_tile_size(Decoder &j, const Tile &tile) {
    u64 total = 0;
    for (u32 c = 0; c < j.image.numcomps; ++c) {
        const Comp &ic = j.image.comps[c];
        u32 size_comp = (ic.prec >> 3) + ((ic.prec & 7) ? 1 : 0);
        if (size_comp == 3) size_comp = 4;
        const TileComp &tc = tile.comps[c];
        const Res &r = tc.resolutions[tc.minimum_num_resolutions - 1];
        u64 n = (u64)(u32)((r.x1 - r.x0) * (r.y1 - r.y0));
        if (size_comp && 0xffffffffULL / size_comp < n) return 0xffffffffULL;
        n *= size_comp;
        if (n > 0xffffffffULL - total) return 0xffffffffULL;
        total += n;
    }
    return total;
}

// ---------------------------------------------------------------------------
// Pillow's Jpeg2KDecode.c: the checks, the colour space guess, and the
// unpackers

inline uint8_t clip8(int v) { return v <= 0 ? 0 : v >= 255 ? 255 : (uint8_t)v; }

struct TileInfo {
    u32 x0, y0, x1, y1, nb_comps;
};

inline u32 j2ku_shift(u32 x, int n) { return n < 0 ? x >> -n : x << n; }

struct CompUnpack {
    int shift, offset, csiz;
    void init(const Comp &c, int bits) {
        shift = bits - (int)c.prec;
        offset = c.sgnd ? 1 << (c.prec - 1) : 0;
        csiz = (int)(c.prec + 7) >> 3;
        if (csiz == 3) csiz = 4;
        if (shift < 0) offset += 1 << (-shift - 1);
    }
    u32 word(const uint8_t *p) const {
        switch (csiz) {
        case 1: return p[0];
        case 2: { uint16_t v; memcpy(&v, p, 2); return v; }
        default: { u32 v; memcpy(&v, p, 4); return v; }
        }
    }
    u32 value(const uint8_t *p) const {
        return j2ku_shift((u32)offset + word(p), shift);
    }
};

// Pillow's ImagingConvertYCbCr2RGB as tables read off its output over
// every (Cb, Cr): the red and blue offsets, and two green terms whose
// sum is shifted right by 6 (any pair that gives Pillow's offsets for
// all 65536 pairs; tests/test_torch_jpeg2k.py holds them to Pillow)
const int16_t YCC_R_CR[256] = {
    -180, -179, -177, -176, -174, -173, -172, -170, -169, -167, -166, -165,
    -163, -162, -160, -159, -158, -156, -155, -153, -152, -150, -149, -148,
    -146, -145, -143, -142, -141, -139, -138, -136, -135, -134, -132, -131,
    -129, -128, -127, -125, -124, -122, -121, -120, -118, -117, -115, -114,
    -113, -111, -110, -108, -107, -106, -104, -103, -101, -100, -99, -97,
    -96, -94, -93, -92, -90, -89, -87, -86, -85, -83, -82, -80,
    -79, -78, -76, -75, -73, -72, -71, -69, -68, -66, -65, -64,
    -62, -61, -59, -58, -57, -55, -54, -52, -51, -50, -48, -47,
    -45, -44, -43, -41, -40, -38, -37, -36, -34, -33, -31, -30,
    -29, -27, -26, -24, -23, -22, -20, -19, -17, -16, -14, -13,
    -12, -10, -9, -7, -6, -5, -3, -2, 0, 1, 2, 4,
    5, 7, 8, 9, 11, 12, 14, 15, 16, 18, 19, 21,
    22, 23, 25, 26, 28, 29, 30, 32, 33, 35, 36, 37,
    39, 40, 42, 43, 44, 46, 47, 49, 50, 51, 53, 54,
    56, 57, 58, 60, 61, 63, 64, 65, 67, 68, 70, 71,
    72, 74, 75, 77, 78, 79, 81, 82, 84, 85, 86, 88,
    89, 91, 92, 93, 95, 96, 98, 99, 100, 102, 103, 105,
    106, 107, 109, 110, 112, 113, 114, 116, 117, 119, 120, 121,
    123, 124, 126, 127, 128, 130, 131, 133, 134, 136, 137, 138,
    140, 141, 143, 144, 145, 147, 148, 150, 151, 152, 154, 155,
    157, 158, 159, 161, 162, 164, 165, 166, 168, 169, 171, 172,
    173, 175, 176, 178,
};
const int16_t YCC_B_CB[256] = {
    -227, -226, -224, -222, -220, -218, -217, -215, -213, -211, -210, -208,
    -206, -204, -202, -201, -199, -197, -195, -194, -192, -190, -188, -187,
    -185, -183, -181, -179, -178, -176, -174, -172, -171, -169, -167, -165,
    -164, -162, -160, -158, -156, -155, -153, -151, -149, -148, -146, -144,
    -142, -140, -139, -137, -135, -133, -132, -130, -128, -126, -125, -123,
    -121, -119, -117, -116, -114, -112, -110, -109, -107, -105, -103, -101,
    -100, -98, -96, -94, -93, -91, -89, -87, -86, -84, -82, -80,
    -78, -77, -75, -73, -71, -70, -68, -66, -64, -62, -61, -59,
    -57, -55, -54, -52, -50, -48, -47, -45, -43, -41, -39, -38,
    -36, -34, -32, -31, -29, -27, -25, -24, -22, -20, -18, -16,
    -15, -13, -11, -9, -8, -6, -4, -2, 0, 1, 3, 5,
    7, 8, 10, 12, 14, 15, 17, 19, 21, 23, 24, 26,
    28, 30, 31, 33, 35, 37, 38, 40, 42, 44, 46, 47,
    49, 51, 53, 54, 56, 58, 60, 62, 63, 65, 67, 69,
    70, 72, 74, 76, 77, 79, 81, 83, 85, 86, 88, 90,
    92, 93, 95, 97, 99, 101, 102, 104, 106, 108, 109, 111,
    113, 115, 116, 118, 120, 122, 124, 125, 127, 129, 131, 132,
    134, 136, 138, 139, 141, 143, 145, 147, 148, 150, 152, 154,
    155, 157, 159, 161, 163, 164, 166, 168, 170, 171, 173, 175,
    177, 178, 180, 182, 184, 186, 187, 189, 191, 193, 194, 196,
    198, 200, 202, 203, 205, 207, 209, 210, 212, 214, 216, 217,
    219, 221, 223, 225,
};
const int16_t YCC_G_CB[256] = {
    2817, 2807, 2761, 2753, 2707, 2697, 2687, 2643, 2633, 2621, 2579, 2567,
    2557, 2514, 2501, 2493, 2448, 2437, 2428, 2382, 2373, 2362, 2318, 2308,
    2297, 2254, 2242, 2233, 2187, 2177, 2168, 2121, 2113, 2102, 2057, 2048,
    2003, 1993, 1982, 1939, 1928, 1917, 1875, 1862, 1853, 1809, 1797, 1789,
    1743, 1733, 1723, 1678, 1669, 1657, 1614, 1603, 1593, 1549, 1537, 1529,
    1483, 1473, 1464, 1417, 1409, 1398, 1353, 1344, 1299, 1289, 1277, 1235,
    1223, 1213, 1170, 1157, 1149, 1104, 1093, 1084, 1038, 1029, 1018, 974,
    964, 953, 910, 898, 889, 844, 833, 825, 778, 769, 759, 713,
    705, 659, 649, 639, 595, 585, 573, 531, 519, 509, 466, 453,
    445, 399, 389, 379, 334, 325, 313, 270, 259, 249, 205, 193,
    185, 139, 129, 120, 73, 65, 54, 9, 0, -45, -55, -65,
    -109, -119, -131, -173, -185, -195, -238, -251, -259, -304, -315, -324,
    -370, -379, -390, -434, -444, -455, -499, -511, -519, -565, -575, -584,
    -631, -639, -650, -695, -704, -749, -759, -770, -813, -824, -835, -877,
    -890, -899, -943, -955, -963, -1009, -1019, -1029, -1074, -1083, -1095, -1138,
    -1149, -1159, -1203, -1215, -1223, -1269, -1279, -1288, -1335, -1343, -1389, -1399,
    -1409, -1453, -1463, -1475, -1517, -1529, -1539, -1582, -1595, -1603, -1648, -1659,
    -1668, -1714, -1723, -1734, -1778, -1788, -1799, -1842, -1854, -1863, -1908, -1919,
    -1927, -1974, -1983, -1993, -2039, -2047, -2093, -2103, -2113, -2157, -2167, -2179,
    -2221, -2234, -2243, -2287, -2299, -2307, -2353, -2363, -2373, -2418, -2427, -2439,
    -2482, -2493, -2503, -2547, -2559, -2567, -2613, -2623, -2632, -2679, -2687, -2698,
    -2743, -2752, -2797, -2807,
};
const int16_t YCC_G_CR[256] = {
    5869, 5815, 5759, 5703, 5682, 5627, 5571, 5549, 5495, 5439, 5383, 5362,
    5307, 5251, 5229, 5175, 5119, 5063, 5043, 4987, 4931, 4909, 4855, 4799,
    4743, 4723, 4667, 4611, 4589, 4535, 4479, 4423, 4403, 4347, 4291, 4270,
    4215, 4159, 4103, 4083, 4027, 3971, 3950, 3895, 3839, 3784, 3763, 3707,
    3651, 3630, 3575, 3519, 3464, 3443, 3387, 3331, 3310, 3255, 3199, 3144,
    3123, 3067, 3012, 2990, 2935, 2879, 2824, 2803, 2747, 2692, 2670, 2615,
    2559, 2504, 2483, 2427, 2372, 2350, 2295, 2240, 2184, 2163, 2107, 2052,
    2030, 1975, 1920, 1864, 1843, 1787, 1732, 1710, 1655, 1600, 1544, 1523,
    1468, 1412, 1390, 1335, 1280, 1224, 1203, 1148, 1092, 1070, 1016, 960,
    904, 883, 828, 772, 750, 696, 640, 584, 563, 508, 452, 430,
    376, 320, 264, 244, 188, 132, 110, 56, 0, -55, -75, -131,
    -187, -209, -263, -319, -375, -395, -451, -507, -528, -583, -639, -695,
    -715, -771, -827, -848, -903, -959, -1015, -1035, -1091, -1147, -1168, -1223,
    -1279, -1334, -1355, -1411, -1467, -1488, -1543, -1599, -1654, -1675, -1731, -1786,
    -1808, -1863, -1919, -1974, -1995, -2051, -2106, -2128, -2183, -2239, -2294, -2315,
    -2371, -2426, -2448, -2503, -2558, -2614, -2635, -2691, -2746, -2768, -2823, -2878,
    -2934, -2955, -3011, -3066, -3088, -3143, -3198, -3254, -3275, -3330, -3386, -3408,
    -3463, -3518, -3574, -3595, -3650, -3706, -3728, -3783, -3838, -3894, -3915, -3970,
    -4026, -4048, -4102, -4158, -4214, -4235, -4290, -4346, -4368, -4422, -4478, -4534,
    -4554, -4610, -4666, -4688, -4742, -4798, -4854, -4874, -4930, -4986, -5008, -5062,
    -5118, -5174, -5194, -5250, -5306, -5327, -5382, -5438, -5494, -5514, -5570, -5626,
    -5647, -5702, -5758, -5780,
};

void ycbcr_to_rgb(uint8_t *px, u32 n) {
    for (u32 i = 0; i < n; ++i, px += 4) {
        int y = px[0], cb = px[1], cr = px[2];
        int r = y + YCC_R_CR[cr];
        int g = y + ((YCC_G_CB[cb] + YCC_G_CR[cr]) >> 6);
        int b = y + YCC_B_CB[cb];
        px[0] = clip8(r);
        px[1] = clip8(g);
        px[2] = clip8(b);
    }
}

enum Unpacker { U_NONE, U_GRAY_L, U_GRAY_I, U_GRAY_RGB, U_GRAYA_LA,
                U_SRGB_RGB, U_SYCC_RGB, U_SRGBA_RGBA, U_SYCCA_RGBA };

struct UnpackEntry {
    int mode, color_space;
    u32 components;
    bool subsampling;
    Unpacker unpacker;
};

const UnpackEntry UNPACKERS[] = {
    {M_L, CS_GRAY, 1, false, U_GRAY_L},
    {M_P, CS_SRGB, 1, false, U_GRAY_L},
    {M_PA, CS_SRGB, 2, false, U_GRAYA_LA},
    {M_I16, CS_GRAY, 1, false, U_GRAY_I},
    {M_LA, CS_GRAY, 2, false, U_GRAYA_LA},
    {M_RGB, CS_GRAY, 1, false, U_GRAY_RGB},
    {M_RGB, CS_GRAY, 2, false, U_GRAY_RGB},
    {M_RGB, CS_SRGB, 3, true, U_SRGB_RGB},
    {M_RGB, CS_SYCC, 3, true, U_SYCC_RGB},
    {M_RGB, CS_SRGB, 4, true, U_SRGB_RGB},
    {M_RGB, CS_SYCC, 4, true, U_SYCC_RGB},
    {M_RGBA, CS_GRAY, 1, false, U_GRAY_RGB},
    {M_RGBA, CS_GRAY, 2, false, U_GRAYA_LA},
    {M_RGBA, CS_SRGB, 3, true, U_SRGB_RGB},
    {M_RGBA, CS_SYCC, 3, true, U_SYCC_RGB},
    {M_RGBA, CS_GRAY, 4, true, U_SRGBA_RGBA},
    {M_RGBA, CS_SRGB, 4, true, U_SRGBA_RGBA},
    {M_RGBA, CS_SYCC, 4, true, U_SYCCA_RGBA},
    {M_CMYK, CS_CMYK, 4, true, U_SRGBA_RGBA},
};

struct PillowImage {
    int mode;
    u32 xsize, ysize;
    uint8_t *pixels;
    u32 pixelsize;
    uint8_t *row(u32 y) { return pixels + (size_t)y * xsize * pixelsize; }
};

void unpack(Unpacker u, const Image &in, const TileInfo &ti,
            const uint8_t *data, PillowImage &im) {
    u32 x0 = ti.x0 - in.x0, y0 = ti.y0 - in.y0;
    u32 w = ti.x1 - ti.x0, h = ti.y1 - ti.y0;
    switch (u) {
    case U_GRAY_L:
    case U_GRAY_I:
    case U_GRAY_RGB: {
        CompUnpack c;
        c.init(in.comps[0], u == U_GRAY_I ? 16 : 8);
        for (u32 y = 0; y < h; ++y) {
            const uint8_t *d = data + (size_t)c.csiz * y * w;
            uint8_t *row = im.row(y0 + y);
            for (u32 x = 0; x < w; ++x, d += c.csiz) {
                u32 v = c.value(d);
                if (u == U_GRAY_L) {
                    row[x0 + x] = (uint8_t)v;
                } else if (u == U_GRAY_I) {
                    uint16_t s16 = (uint16_t)v;
                    memcpy(row + 2 * (x0 + x), &s16, 2);
                } else {
                    uint8_t *p = row + 4 * (x0 + x);
                    p[0] = p[1] = p[2] = (uint8_t)v;
                    p[3] = 255;
                }
            }
        }
        break;
    }
    case U_GRAYA_LA: {
        CompUnpack c, a;
        c.init(in.comps[0], 8);
        a.init(in.comps[1], 8);
        const uint8_t *adata = data + (size_t)c.csiz * w * h;
        for (u32 y = 0; y < h; ++y) {
            const uint8_t *d = data + (size_t)c.csiz * y * w;
            const uint8_t *ad = adata + (size_t)a.csiz * y * w;
            uint8_t *p = im.row(y0 + y) + 4 * x0;
            for (u32 x = 0; x < w; ++x, d += c.csiz, ad += a.csiz, p += 4) {
                uint8_t v = (uint8_t)c.value(d);
                p[0] = p[1] = p[2] = v;
                p[3] = (uint8_t)a.value(ad);
            }
        }
        break;
    }
    default: {
        // sRGB, sYCC, with alpha or not: components subsampled by w / dx
        u32 nc = (u == U_SRGBA_RGBA || u == U_SYCCA_RGBA) ? 4 : 3;
        CompUnpack c[4];
        const uint8_t *cdata[4];
        u32 dx[4], dy[4];
        const uint8_t *cptr = data;
        for (u32 n = 0; n < nc; ++n) {
            cdata[n] = cptr;
            c[n].init(in.comps[n], 8);
            dx[n] = in.comps[n].dx;
            dy[n] = in.comps[n].dy;
            cptr += (size_t)c[n].csiz * (w / dx[n]) * (h / dy[n]);
        }
        for (u32 y = 0; y < h; ++y) {
            const uint8_t *d[4];
            uint8_t *row = im.row(y0 + y) + 4 * x0;
            for (u32 n = 0; n < nc; ++n)
                d[n] = cdata[n] + (size_t)c[n].csiz * (y / dy[n]) * (w / dx[n]);
            uint8_t *p = row;
            for (u32 x = 0; x < w; ++x, p += 4) {
                for (u32 n = 0; n < nc; ++n)
                    p[n] = (uint8_t)c[n].value(d[n] + (size_t)c[n].csiz *
                                                          (x / dx[n]));
                if (nc == 3) p[3] = 255;
            }
            if (u == U_SYCC_RGB || u == U_SYCCA_RGBA) ycbcr_to_rgb(row, w);
        }
        break;
    }
    }
}

// what the tests read of OpenJPEG's tile loop (j2k_tiles): each tile's
// index, bounds, data size and result, and the first data_size bytes of
// its buffer, in the order decoded
struct TileSink {
    uint8_t *out;
    i64 cap;
    i64 *info;
    int max_tiles;
    int *count;
    i64 at = 0;

    void add(u32 tileno, const Tile &tile, u64 size, bool ok,
             const uint8_t *buf) {
        if (*count >= max_tiles) return;
        i64 *t = info + 7 * *count;
        t[0] = tileno;
        t[1] = tile.x0;
        t[2] = tile.y0;
        t[3] = tile.x1;
        t[4] = tile.y1;
        t[5] = (i64)size;
        t[6] = ok;
        if (at + (i64)size <= cap) memcpy(out + at, buf, size);
        at += (i64)size;
        ++*count;
    }
};

// the stage that failed: OpenJPEG's opj_read_header, opj_read_tile_header,
// opj_decode_tile_data, opj_end_decompress, or Pillow's own checks
enum Failed { F_NONE, F_HEADER, F_TILE_HEADER, F_TILE_DATA, F_END, F_PILLOW };

// j2k_decode_entry: Pillow's loop over OpenJPEG's tile calls. With a sink
// (the tests) OpenJPEG's calls alone run, and each tile goes to the sink
// instead of Pillow's checks and unpacker.
int decode_entry(const uint8_t *file, i64 n, int codec, int mode, u32 xsize,
                 u32 ysize, uint8_t *out, TileSink *sink) {
    Decoder j;
    j.s.d = file;
    j.s.len = n;
    Jp2 jp2;
    if (codec == 2) {
        if (!jp2_read_boxes(jp2, j)) return F_HEADER;
        if (!jp2.has_jp2h || !jp2.has_ihdr) return F_HEADER;
    }
    if (!j.read_main_header()) return F_HEADER;
    Image &image = j.image;
    Unpacker u = U_NONE;
    if (!sink) {
        if (codec == 2) {
            u32 e = jp2.enumcs;
            image.color_space = e == 16 ? CS_SRGB : e == 17 ? CS_GRAY
                                : e == 18 ? CS_SYCC : e == 24 ? CS_EYCC
                                : e == 12 ? CS_CMYK : CS_UNKNOWN;
        }
        if (image.numcomps < 1 || image.numcomps > 4) return F_PILLOW;
        int subsampling = -1;
        for (u32 c = 0; c < image.numcomps; ++c)
            if (image.comps[c].dx != 1 || image.comps[c].dy != 1) {
                subsampling = (int)c;
                break;
            }
        // an unknown colour space (a colr box OpenJPEG does not map, or
        // none) is guessed as an unspecified one is
        int cs = image.color_space;
        if (cs == CS_UNSPECIFIED || cs == CS_UNKNOWN) {
            switch (image.numcomps) {
            case 1:
            case 2: cs = CS_GRAY; break;
            case 3:
            case 4:
                switch (subsampling) {
                case -1:
                case 0:
                case 3: cs = CS_SRGB; break;
                case 1:
                case 2: cs = CS_SYCC; break;
                }
                break;
            }
        }
        for (const UnpackEntry &e : UNPACKERS)
            if (cs == e.color_space && image.numcomps == e.components &&
                (e.subsampling || subsampling == -1) && mode == e.mode) {
                u = e.unpacker;
                break;
            }
        if (u == U_NONE) return F_PILLOW;
    }
    PillowImage im{mode, xsize, ysize, out,
                   (u32)(mode == M_L || mode == M_P ? 1
                         : mode == M_I16 ? 2 : 4)};
    std::vector<uint8_t> buffer;       // Pillow's state->buffer
    for (;;) {
        bool go_on = false;
        if (!j.read_tile_header(go_on)) return F_TILE_HEADER;
        if (!go_on) break;
        u32 tileno = j.current_tile;
        Tile tile;
        if (!init_tile(j, tileno, tile)) return F_TILE_HEADER;
        u64 opj_size = decoded_tile_size(j, tile);
        if (opj_size == 0xffffffffULL) return F_TILE_HEADER;
        u64 data_size = opj_size;
        TileInfo ti{(u32)tile.x0, (u32)tile.y0, (u32)tile.x1, (u32)tile.y1,
                    image.numcomps};
        if (!sink) {
            if ((i32)ti.x0 >= (i32)ti.x1 || (i32)ti.y0 >= (i32)ti.y1 ||
                (i32)ti.x0 < 0 || (i32)ti.y0 < 0 ||
                ti.x1 - image.x0 > xsize || ti.y1 - image.y0 > ysize)
                return F_PILLOW;
            // the bytes Pillow's unpackers may read: each component's
            // width (3 bytes taken as 4) over the tile. (Pillow sums the
            // widths over the tiles so far for its overflow check, which
            // only an image past its pixel limit could fail.)
            u64 tcw = 0;
            for (u32 c = 0; c < ti.nb_comps; ++c) {
                u32 csize = (image.comps[c].prec + 7) >> 3;
                tcw += csize == 3 ? 4 : csize;
            }
            u64 tile_bytes = (u64)(ti.x1 - ti.x0) * (ti.y1 - ti.y0) * tcw;
            if (tile_bytes > data_size) data_size = tile_bytes;
        }
        // Pillow's buffer is zeroed for each tile (a component with no
        // samples in the tile reads zeros where the next one would be)
        if (buffer.size() < data_size) buffer.resize(data_size);
        memset(buffer.data(), 0, data_size);
        // opj_decode_tile_data writes the tile into the first bytes
        bool ok = j.decode_tile(tileno, tile, buffer);
        if (sink) sink->add(tileno, tile, opj_size, ok, buffer.data());
        if (!ok) return F_TILE_DATA;
        if (!sink) unpack(u, image, ti, buffer.data(), im);
    }
    // opj_end_decompress: the JP2 boxes after the codestream
    if (codec == 2 && !jp2_read_boxes(jp2, j)) return F_END;
    return F_NONE;
}

}  // namespace

extern "C" int j2k_decode(const uint8_t *file, int64_t n, int codec, int mode,
                          int width, int height, uint8_t *out) {
    try {
        return decode_entry(file, n, codec, mode, (u32)width, (u32)height,
                            out, nullptr);
    } catch (const std::bad_alloc &) {   // OpenJPEG's allocations fail
        return F_TILE_HEADER;
    }
}

extern "C" int j2k_tiles(const uint8_t *file, int64_t n, int codec,
                         uint8_t *out, int64_t cap, int64_t *info,
                         int max_tiles, int *count) {
    try {
        *count = 0;
        TileSink sink{out, cap, info, max_tiles, count};
        return decode_entry(file, n, codec, 0, 0, 0, nullptr, &sink);
    } catch (const std::bad_alloc &) {
        return F_TILE_HEADER;
    }
}

// Pillow's YCbCr to RGB of n 4-byte pixels in place (the sYCC unpackers')
extern "C" void j2k_ycbcr_rgb(uint8_t *px, int64_t n) {
    ycbcr_to_rgb(px, (u32)n);
}
