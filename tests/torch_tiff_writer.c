/* The tests' TIFF writer: libtiff 4.7.1 (Pillow 12.1.0's bundled
 * pillow.libs/libtiff-*.so.6.2.0, built against the system's tiffio.h)
 * writing what Pillow's own writer never writes: tiles, planar
 * configuration 2, predictors 2 and 3, BigTIFF, fill order 2, 2- and
 * 4-bit samples, extra samples, partial last strips; and JPEG (libtiff's
 * tif_jpeg.c over Pillow's libjpeg-turbo 3.1.3) with the YCbCr tags:
 * subsampling, JPEGCOLORMODE (RGB: libtiff converts RGB rows to YCbCr),
 * JPEGTABLESMODE, quality, ReferenceBlackWhite, YCbCrCoefficients and
 * YCbCrPositioning; ZSTD (over Pillow's libzstd 1.5.7) at a
 * TIFFTAG_ZSTD_LEVEL and LZMA (over its liblzma 5.8.2) at a
 * TIFFTAG_LZMAPRESET, where their SPEC_ fields are not 0; the CCITT fax
 * codecs (RLE, RLEW, Group 3, Group 4) with T4Options and T6Options.
 *
 * tw_write(path, spec, colormap, pixels, floats): spec is an int array
 * (SPEC_* below); floats holds ReferenceBlackWhite (6) then
 * YCbCrCoefficients (3), each set where its SPEC_ flag is; pixels are the
 * image's rows as libtiff takes them, 16- and
 * 32-bit samples in the host's order: contiguous, height rows of
 * ceil(width * spp * bps / 8) bytes; separate, spp planes of height rows
 * of ceil(width * bps / 8) bytes. Tiles are cut from those rows (a tile's
 * width is a multiple of 16, so every tile starts on a byte) and padded
 * with zeros. Returns 0, or -1 where libtiff refuses.
 *
 * tw_write_raw(path, spec, colormap, data, sizes, n, floats): the same
 * directory, its n strips or tiles written as they are (TIFFWriteRawStrip
 * or TIFFWriteRawTile): chunk i is sizes[i] bytes of data, in order. For
 * streams no libtiff encoder writes: ThunderScan, cut or damaged fax
 * data, strips at odd offsets.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <tiffio.h>

enum {
    SPEC_WIDTH, SPEC_HEIGHT, SPEC_SPP, SPEC_BPS, SPEC_SAMPLEFORMAT,
    SPEC_PHOTOMETRIC, SPEC_COMPRESSION, SPEC_PREDICTOR, SPEC_PLANAR,
    SPEC_FILLORDER, SPEC_ROWS_PER_STRIP, SPEC_TILE_WIDTH, SPEC_TILE_HEIGHT,
    SPEC_ORIENTATION, SPEC_BIGTIFF, SPEC_BIGENDIAN, SPEC_N_EXTRA,
    SPEC_EXTRA0, SPEC_EXTRA1, SPEC_EXTRA2, SPEC_SUB_H, SPEC_SUB_V,
    SPEC_JPEGCOLORMODE, SPEC_JPEGTABLESMODE, SPEC_QUALITY, SPEC_REFBW,
    SPEC_COEFFICIENTS, SPEC_POSITIONING, SPEC_ZSTD_LEVEL, SPEC_LZMA_PRESET,
    SPEC_T4OPTIONS, SPEC_T6OPTIONS, SPEC_COUNT
};

static void quiet(const char *module, const char *fmt, va_list ap) {
    (void)module; (void)fmt; (void)ap;
}

/* A file open for writing with spec's directory set, or NULL. */
static TIFF *tw_open(const char *path, const int *spec,
                     const uint16_t *colormap, const float *floats) {
    TIFFSetWarningHandler(quiet);
    TIFFSetErrorHandler(quiet);
    char mode[8] = "w";
    if (spec[SPEC_BIGTIFF]) strcat(mode, "8");
    strcat(mode, spec[SPEC_BIGENDIAN] ? "b" : "l");
    TIFF *tif = TIFFOpen(path, mode);
    if (!tif) return NULL;
    const uint32_t w = spec[SPEC_WIDTH], h = spec[SPEC_HEIGHT];
    const int spp = spec[SPEC_SPP], bps = spec[SPEC_BPS];
    const int planar = spec[SPEC_PLANAR];
    int ok = 1;
    ok &= TIFFSetField(tif, TIFFTAG_IMAGEWIDTH, w);
    ok &= TIFFSetField(tif, TIFFTAG_IMAGELENGTH, h);
    ok &= TIFFSetField(tif, TIFFTAG_SAMPLESPERPIXEL, spp);
    ok &= TIFFSetField(tif, TIFFTAG_BITSPERSAMPLE, bps);
    ok &= TIFFSetField(tif, TIFFTAG_SAMPLEFORMAT, spec[SPEC_SAMPLEFORMAT]);
    ok &= TIFFSetField(tif, TIFFTAG_PHOTOMETRIC, spec[SPEC_PHOTOMETRIC]);
    ok &= TIFFSetField(tif, TIFFTAG_COMPRESSION, spec[SPEC_COMPRESSION]);
    ok &= TIFFSetField(tif, TIFFTAG_PLANARCONFIG, planar);
    ok &= TIFFSetField(tif, TIFFTAG_FILLORDER, spec[SPEC_FILLORDER]);
    if (spec[SPEC_PREDICTOR] > 1)
        ok &= TIFFSetField(tif, TIFFTAG_PREDICTOR, spec[SPEC_PREDICTOR]);
    if (spec[SPEC_ORIENTATION])
        ok &= TIFFSetField(tif, TIFFTAG_ORIENTATION, spec[SPEC_ORIENTATION]);
    if (spec[SPEC_N_EXTRA]) {
        uint16_t extra[3] = {(uint16_t)spec[SPEC_EXTRA0],
                             (uint16_t)spec[SPEC_EXTRA1],
                             (uint16_t)spec[SPEC_EXTRA2]};
        ok &= TIFFSetField(tif, TIFFTAG_EXTRASAMPLES, spec[SPEC_N_EXTRA],
                           extra);
    }
    if (colormap) {
        const size_t n = (size_t)1 << bps;
        ok &= TIFFSetField(tif, TIFFTAG_COLORMAP, colormap, colormap + n,
                           colormap + 2 * n);
    }
    if (spec[SPEC_SUB_H])
        ok &= TIFFSetField(tif, TIFFTAG_YCBCRSUBSAMPLING, spec[SPEC_SUB_H],
                           spec[SPEC_SUB_V]);
    if (spec[SPEC_POSITIONING])
        ok &= TIFFSetField(tif, TIFFTAG_YCBCRPOSITIONING,
                           spec[SPEC_POSITIONING]);
    if (spec[SPEC_REFBW])
        ok &= TIFFSetField(tif, TIFFTAG_REFERENCEBLACKWHITE, floats);
    if (spec[SPEC_COEFFICIENTS])
        ok &= TIFFSetField(tif, TIFFTAG_YCBCRCOEFFICIENTS, floats + 6);
    if (spec[SPEC_COMPRESSION] == COMPRESSION_JPEG) {
        if (spec[SPEC_QUALITY])
            ok &= TIFFSetField(tif, TIFFTAG_JPEGQUALITY, spec[SPEC_QUALITY]);
        if (spec[SPEC_JPEGTABLESMODE] >= 0)
            ok &= TIFFSetField(tif, TIFFTAG_JPEGTABLESMODE,
                               spec[SPEC_JPEGTABLESMODE]);
        if (spec[SPEC_JPEGCOLORMODE])
            ok &= TIFFSetField(tif, TIFFTAG_JPEGCOLORMODE, JPEGCOLORMODE_RGB);
    }
    if (spec[SPEC_COMPRESSION] == COMPRESSION_ZSTD && spec[SPEC_ZSTD_LEVEL])
        ok &= TIFFSetField(tif, TIFFTAG_ZSTD_LEVEL, spec[SPEC_ZSTD_LEVEL]);
    if (spec[SPEC_COMPRESSION] == COMPRESSION_LZMA && spec[SPEC_LZMA_PRESET])
        ok &= TIFFSetField(tif, TIFFTAG_LZMAPRESET, spec[SPEC_LZMA_PRESET]);
    if (spec[SPEC_COMPRESSION] == COMPRESSION_CCITTFAX3 && spec[SPEC_T4OPTIONS])
        ok &= TIFFSetField(tif, TIFFTAG_GROUP3OPTIONS,
                           (uint32_t)spec[SPEC_T4OPTIONS]);
    if (spec[SPEC_COMPRESSION] == COMPRESSION_CCITTFAX4 && spec[SPEC_T6OPTIONS])
        ok &= TIFFSetField(tif, TIFFTAG_GROUP4OPTIONS,
                           (uint32_t)spec[SPEC_T6OPTIONS]);
    if (spec[SPEC_TILE_WIDTH] > 0) {
        ok &= TIFFSetField(tif, TIFFTAG_TILEWIDTH, spec[SPEC_TILE_WIDTH]);
        ok &= TIFFSetField(tif, TIFFTAG_TILELENGTH, spec[SPEC_TILE_HEIGHT]);
    } else {
        ok &= TIFFSetField(tif, TIFFTAG_ROWSPERSTRIP,
                           spec[SPEC_ROWS_PER_STRIP]);
    }
    if (!ok) { TIFFClose(tif); return NULL; }
    return tif;
}

extern "C" int tw_write(const char *path, const int *spec,
                        const uint16_t *colormap, const uint8_t *pixels,
                        const float *floats) {
    TIFF *tif = tw_open(path, spec, colormap, floats);
    if (!tif) return -1;
    const uint32_t w = spec[SPEC_WIDTH], h = spec[SPEC_HEIGHT];
    const int spp = spec[SPEC_SPP], bps = spec[SPEC_BPS];
    const int planar = spec[SPEC_PLANAR];
    const int tiled = spec[SPEC_TILE_WIDTH] > 0;
    int ok = 1;
    const int planes = planar == PLANARCONFIG_SEPARATE ? spp : 1;
    const int bits = (planar == PLANARCONFIG_SEPARATE ? 1 : spp) * bps;
    const size_t row = ((size_t)w * bits + 7) / 8;
    const uint8_t *plane0 = pixels;
    if (!tiled) {
        const uint32_t rps = spec[SPEC_ROWS_PER_STRIP];
        const uint32_t per_plane = (h + rps - 1) / rps;
        for (int p = 0; p < planes && ok; p++) {
            const uint8_t *img = plane0 + (size_t)p * row * h;
            for (uint32_t s = 0; s < per_plane && ok; s++) {
                uint32_t y0 = s * rps, rows = h - y0 < rps ? h - y0 : rps;
                ok = TIFFWriteEncodedStrip(
                    tif, s + p * per_plane, (void *)(img + y0 * row),
                    (tmsize_t)(row * rows)) >= 0;
            }
        }
    } else {
        const uint32_t tw = spec[SPEC_TILE_WIDTH], th = spec[SPEC_TILE_HEIGHT];
        const size_t trow = ((size_t)tw * bits + 7) / 8;
        uint8_t *buf = (uint8_t *)malloc(trow * th);
        for (int p = 0; p < planes && ok; p++) {
            const uint8_t *img = plane0 + (size_t)p * row * h;
            for (uint32_t y0 = 0; y0 < h && ok; y0 += th) {
                for (uint32_t x0 = 0; x0 < w && ok; x0 += tw) {
                    memset(buf, 0, trow * th);
                    size_t at = (size_t)x0 * bits / 8;
                    size_t n = row - at < trow ? row - at : trow;
                    for (uint32_t y = 0; y < th && y0 + y < h; y++)
                        memcpy(buf + y * trow, img + (y0 + y) * row + at, n);
                    ok = TIFFWriteTile(tif, buf, x0, y0, 0, p) >= 0;
                }
            }
        }
        free(buf);
    }
    if (ok) ok = TIFFWriteDirectory(tif);
    TIFFClose(tif);
    return ok ? 0 : -1;
}

extern "C" int tw_write_raw(const char *path, const int *spec,
                            const uint16_t *colormap, const uint8_t *data,
                            const int64_t *sizes, int n, const float *floats) {
    TIFF *tif = tw_open(path, spec, colormap, floats);
    if (!tif) return -1;
    const int tiled = spec[SPEC_TILE_WIDTH] > 0;
    int ok = 1;
    for (int i = 0; i < n && ok; i++) {
        ok = (tiled ? TIFFWriteRawTile(tif, i, (void *)data, sizes[i])
                    : TIFFWriteRawStrip(tif, i, (void *)data, sizes[i])) >= 0;
        data += sizes[i];
    }
    if (ok) ok = TIFFWriteDirectory(tif);
    TIFFClose(tif);
    return ok ? 0 : -1;
}
