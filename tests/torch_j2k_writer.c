/* The tests' JPEG 2000 codestream writer over Pillow's bundled OpenJPEG
 * 2.5.4 (pillow.libs/libopenjp2-*.so.2.5.4), for what Pillow's own
 * writer does not reach: every code-block style bit, SOP and EPH, POC,
 * RGN, component subsampling and offsets, signed components, precisions
 * 1-16, tile-parts, the colour space of a JP2.
 *
 * It declares OpenJPEG 2.5's structures itself, so that it builds without
 * openjpeg.h; the offsets the library's defaults pin
 * (opj_set_default_encoder_parameters) are asserted below, and
 * tests/torch_jpeg2k_corpus.py holds every file to Pillow's read. Built at
 * first use by the corpus module:
 *
 *   gcc -O2 -shared -fPIC -o torch_j2k_writer.so tests/torch_j2k_writer.c
 *
 * and called through ctypes after libopenjp2 is loaded (RTLD_GLOBAL).
 */

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef int OPJ_BOOL;
typedef struct opj_poc {
    uint32_t resno0, compno0;
    uint32_t layno1, resno1, compno1;
    uint32_t layno0, precno0, precno1;
    int prg1, prg;
    char progorder[5];
    uint32_t tile;
    int32_t tx0, tx1, ty0, ty1;
    uint32_t layS, resS, compS, prcS;
    uint32_t layE, resE, compE, prcE;
    uint32_t txS, txE, tyS, tyE, dx, dy;
    uint32_t lay_t, res_t, comp_t, prc_t, tx0_t, ty0_t;
} opj_poc_t;

typedef struct opj_cparameters {
    OPJ_BOOL tile_size_on;
    int cp_tx0, cp_ty0, cp_tdx, cp_tdy;
    int cp_disto_alloc, cp_fixed_alloc, cp_fixed_quality;
    int *cp_matrice;
    char *cp_comment;
    int csty;
    int prog_order;
    opj_poc_t POC[32];
    uint32_t numpocs;
    int tcp_numlayers;
    float tcp_rates[100];
    float tcp_distoratio[100];
    int numresolution;
    int cblockw_init, cblockh_init;
    int mode;
    int irreversible;
    int roi_compno, roi_shift;
    int res_spec;
    int prcw_init[33], prch_init[33];
    char infile[4096], outfile[4096];
    int index_on;
    char index[4096];
    int image_offset_x0, image_offset_y0;
    int subsampling_dx, subsampling_dy;
    int decod_format, cod_format;
    OPJ_BOOL jpwl_epc_on;
    int jpwl_hprot_MH;
    int jpwl_hprot_TPH_tileno[16], jpwl_hprot_TPH[16];
    int jpwl_pprot_tileno[16], jpwl_pprot_packno[16], jpwl_pprot[16];
    int jpwl_sens_size, jpwl_sens_addr, jpwl_sens_range, jpwl_sens_MH;
    int jpwl_sens_TPH_tileno[16], jpwl_sens_TPH[16];
    int cp_cinema;
    int max_comp_size;
    int cp_rsiz;
    char tp_on, tp_flag, tcp_mct;
    OPJ_BOOL jpip_on;
    void *mct_data;
    int max_cs_size;
    uint16_t rsiz;
    char reserved[4096];         /* fields of later versions, unused */
} opj_cparameters_t;

_Static_assert(offsetof(opj_cparameters_t, numresolution) == 5600, "layout");
_Static_assert(offsetof(opj_cparameters_t, roi_compno) == 5620, "layout");
_Static_assert(offsetof(opj_cparameters_t, subsampling_dx) == 18196,
               "layout");
_Static_assert(offsetof(opj_cparameters_t, cod_format) == 18208, "layout");

typedef struct {
    uint32_t dx, dy, w, h, x0, y0, prec, bpp, sgnd;
} opj_image_cmptparm_t;

typedef struct {
    uint32_t dx, dy, w, h, x0, y0, prec, bpp, sgnd, resno_decoded, factor;
    int32_t *data;
    uint16_t alpha;
} opj_image_comp_t;

typedef struct {
    uint32_t x0, y0, x1, y1, numcomps;
    int color_space;
    opj_image_comp_t *comps;
    uint8_t *icc_profile_buf;
    uint32_t icc_profile_len;
} opj_image_t;

typedef size_t (*opj_stream_write_fn)(void *, size_t, void *);
typedef int64_t (*opj_stream_skip_fn)(int64_t, void *);
typedef OPJ_BOOL (*opj_stream_seek_fn)(int64_t, void *);
typedef void (*opj_msg_callback)(const char *, void *);

void opj_set_default_encoder_parameters(opj_cparameters_t *);
void *opj_create_compress(int format);
OPJ_BOOL opj_setup_encoder(void *codec, opj_cparameters_t *, opj_image_t *);
opj_image_t *opj_image_create(uint32_t n, opj_image_cmptparm_t *, int cs);
void opj_image_destroy(opj_image_t *);
void *opj_stream_create(size_t size, OPJ_BOOL input);
void opj_stream_set_write_function(void *, opj_stream_write_fn);
void opj_stream_set_skip_function(void *, opj_stream_skip_fn);
void opj_stream_set_seek_function(void *, opj_stream_seek_fn);
void opj_stream_set_user_data(void *, void *, void (*)(void *));
OPJ_BOOL opj_start_compress(void *, opj_image_t *, void *);
OPJ_BOOL opj_encode(void *, void *);
OPJ_BOOL opj_end_compress(void *, void *);
void opj_stream_destroy(void *);
void opj_destroy_codec(void *);
OPJ_BOOL opj_set_error_handler(void *, opj_msg_callback, void *);
OPJ_BOOL opj_set_MCT(opj_cparameters_t *, float *, int32_t *, uint32_t);

typedef struct {
    uint8_t *buf;
    int64_t cap, pos, len;
} Mem;

static size_t mem_write(void *p, size_t n, void *user) {
    Mem *m = (Mem *)user;
    if (m->pos + (int64_t)n > m->cap) return (size_t)-1;
    memcpy(m->buf + m->pos, p, n);
    m->pos += (int64_t)n;
    if (m->pos > m->len) m->len = m->pos;
    return n;
}

static int64_t mem_skip(int64_t n, void *user) {
    Mem *m = (Mem *)user;
    if (m->pos + n > m->cap || m->pos + n < 0) return -1;
    m->pos += n;
    if (m->pos > m->len) m->len = m->pos;
    return n;
}

static OPJ_BOOL mem_seek(int64_t n, void *user) {
    Mem *m = (Mem *)user;
    if (n < 0 || n > m->cap) return 0;
    m->pos = n;
    if (m->pos > m->len) m->len = m->pos;
    return 1;
}

static void quiet(const char *msg, void *client) {
    (void)msg;
    (void)client;
}

/* opts, in order: 0 codec (0 J2K, 2 JP2), 1 colour space, 2 image x0,
 * 3 image y0, 4 resolutions, 5 code-block width, 6 height, 7 code-block
 * style, 8 irreversible, 9 ROI component (-1 none), 10 ROI shift, 11 Scod
 * (SOP 2, EPH 4), 12 progression, 13 tiles on, 14 tile width, 15 height,
 * 16 tile x0, 17 tile y0, 18 tile-parts on, 19 tile-part flag ('R', 'L',
 * 'C'), 20 MCT, 21 precinct sizes given (n), then n widths and n heights
 * (as exponents, from the highest resolution); 40 Part 2's MCT (a
 * fixed 3x3 matrix through opj_set_MCT). comps: per component dx,
 * dy, prec, sgnd. samples: each component's samples in turn, w * h of its
 * own size. pocs: npoc rows of tile, resno0, compno0, layno1, resno1,
 * compno1, progression. Returns the bytes written, or -1. */
int64_t torch_j2k_write(const int32_t *samples, int width, int height,
                        int ncomp, const int *comps, const int *opts,
                        const float *rates, int nlayers, const int *pocs,
                        int npoc, uint8_t *out, int64_t cap) {
    opj_cparameters_t *p = calloc(1, sizeof *p);
    opj_image_cmptparm_t cp[16];
    int i, c;
    int64_t written = -1;
    int x0 = opts[2], y0 = opts[3];
    opj_set_default_encoder_parameters(p);
    p->numresolution = opts[4];
    p->cblockw_init = opts[5];
    p->cblockh_init = opts[6];
    p->mode = opts[7];
    p->irreversible = opts[8];
    p->roi_compno = opts[9];
    p->roi_shift = opts[10];
    p->csty = opts[11];
    p->prog_order = opts[12];
    p->tile_size_on = opts[13];
    p->cp_tdx = opts[14];
    p->cp_tdy = opts[15];
    p->cp_tx0 = opts[16];
    p->cp_ty0 = opts[17];
    p->tp_on = (char)opts[18];
    p->tp_flag = (char)opts[19];
    p->tcp_mct = (char)opts[20];
    p->image_offset_x0 = x0;
    p->image_offset_y0 = y0;
    if (opts[21]) {
        p->res_spec = opts[21];
        p->csty |= 1;
        for (i = 0; i < opts[21]; ++i) {
            p->prcw_init[i] = 1 << opts[22 + i];
            p->prch_init[i] = 1 << opts[22 + opts[21] + i];
        }
    }
    p->tcp_numlayers = nlayers;
    p->cp_disto_alloc = 1;
    for (i = 0; i < nlayers; ++i) p->tcp_rates[i] = rates[i];
    for (i = 0; i < npoc; ++i) {
        const int *r = pocs + 7 * i;
        p->POC[i].tile = (uint32_t)r[0];
        p->POC[i].resno0 = (uint32_t)r[1];
        p->POC[i].compno0 = (uint32_t)r[2];
        p->POC[i].layno1 = (uint32_t)r[3];
        p->POC[i].resno1 = (uint32_t)r[4];
        p->POC[i].compno1 = (uint32_t)r[5];
        p->POC[i].prg1 = r[6];
    }
    p->numpocs = (uint32_t)npoc;
    if (opts[40]) {
        float matrix[9] = {0.5f, 0.25f, 0.25f, -0.25f, 0.5f, -0.25f,
                           0.25f, -0.25f, 0.5f};
        int32_t shifts[3] = {0, 0, 0};
        opj_set_MCT(p, matrix, shifts, 3);
    }
    memset(cp, 0, sizeof cp);
    for (c = 0; c < ncomp; ++c) {
        uint32_t dx = (uint32_t)comps[4 * c], dy = (uint32_t)comps[4 * c + 1];
        cp[c].dx = dx;
        cp[c].dy = dy;
        cp[c].x0 = (uint32_t)(x0 + dx - 1) / dx;
        cp[c].y0 = (uint32_t)(y0 + dy - 1) / dy;
        cp[c].w = (uint32_t)(x0 + width + dx - 1) / dx - cp[c].x0;
        cp[c].h = (uint32_t)(y0 + height + dy - 1) / dy - cp[c].y0;
        cp[c].prec = (uint32_t)comps[4 * c + 2];
        cp[c].sgnd = (uint32_t)comps[4 * c + 3];
    }
    opj_image_t *image = opj_image_create((uint32_t)ncomp, cp, opts[1]);
    if (!image) goto done;
    image->x0 = (uint32_t)x0;
    image->y0 = (uint32_t)y0;
    image->x1 = (uint32_t)(x0 + width);
    image->y1 = (uint32_t)(y0 + height);
    for (c = 0; c < ncomp; ++c) {
        size_t n = (size_t)image->comps[c].w * image->comps[c].h;
        memcpy(image->comps[c].data, samples, n * sizeof(int32_t));
        samples += n;
    }
    void *codec = opj_create_compress(opts[0]);
    opj_set_error_handler(codec, quiet, NULL);
    Mem m = {out, cap, 0, 0};
    void *s = opj_stream_create(1 << 20, 0);
    opj_stream_set_write_function(s, mem_write);
    opj_stream_set_skip_function(s, mem_skip);
    opj_stream_set_seek_function(s, mem_seek);
    opj_stream_set_user_data(s, &m, NULL);
    if (opj_setup_encoder(codec, p, image) && opj_start_compress(codec, image, s)
        && opj_encode(codec, s) && opj_end_compress(codec, s))
        written = m.len;
    opj_stream_destroy(s);
    opj_destroy_codec(codec);
    opj_image_destroy(image);
done:
    free(p);
    return written;
}
