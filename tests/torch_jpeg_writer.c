/* A JPEG writer for the port's decoder tests, on the system's libjpeg:
 * pixels encoded with any sampling, Huffman or arithmetic coding, a
 * restart interval, a scan script and DAC conditioning; and a lossless
 * transcode (jpeg_read_coefficients -> jpeg_write_coefficients) that
 * changes only the entropy coding, the scan script and the restart
 * interval. tests/torch_jpeg_corpus.py builds it at first use with
 *
 *   g++ -O2 -fPIC -shared -o libjpeg_writer.so torch_jpeg_writer.c -ljpeg
 *
 * and binds it through ctypes. Each call returns 0 and a malloc'd buffer
 * (free it with jw_free), or nonzero where libjpeg stops.
 *
 * A scan script is n_scans rows of 9 ints: components in the scan, their
 * four indices, Ss, Se, Ah, Al (jpeg_scan_info). n_scans 0 with
 * progressive set is jpeg_simple_progression's script; n_scans 0 without
 * it is one sequential scan.
 */
#include <setjmp.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

#ifdef __cplusplus
extern "C" {
#endif

struct jw_error {
  struct jpeg_error_mgr pub;
  jmp_buf jump;
};

static void jw_error_exit(j_common_ptr cinfo) {
  longjmp(((struct jw_error *)cinfo->err)->jump, 1);
}

/* the coding options both entry points share; scans must outlive the
   compression, as libjpeg keeps the pointer */
static void jw_options(j_compress_ptr c, int progressive, int arithmetic,
                       int restart, const int *scans, int n_scans,
                       jpeg_scan_info *info) {
  int i, k;
  c->arith_code = arithmetic ? TRUE : FALSE;
  c->restart_interval = (unsigned int)restart;
  if (n_scans > 0) {
    for (i = 0; i < n_scans; ++i) {
      const int *s = scans + 9 * i;
      info[i].comps_in_scan = s[0];
      for (k = 0; k < 4; ++k) info[i].component_index[k] = s[1 + k];
      info[i].Ss = s[5];
      info[i].Se = s[6];
      info[i].Ah = s[7];
      info[i].Al = s[8];
    }
    c->scan_info = info;
    c->num_scans = n_scans;
  } else if (progressive) {
    jpeg_simple_progression(c);
  }
}

int jw_encode(const unsigned char *pixels, int h, int w, int channels,
              int quality, int h_samp, int v_samp, int progressive,
              int arithmetic, int restart, const int *scans, int n_scans,
              const int *dac, unsigned char **out, unsigned long *out_len) {
  struct jpeg_compress_struct c;
  struct jw_error err;
  jpeg_scan_info *info =
      (jpeg_scan_info *)calloc(n_scans > 0 ? n_scans : 1, sizeof *info);
  JSAMPROW row;
  memset(&c, 0, sizeof c);
  *out = NULL;
  *out_len = 0;
  c.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = jw_error_exit;
  if (setjmp(err.jump)) {
    jpeg_destroy_compress(&c);
    free(info);
    *out = NULL;                     /* may be stale: leaked, not freed */
    return 1;
  }
  jpeg_create_compress(&c);
  jpeg_mem_dest(&c, out, out_len);
  c.image_width = (JDIMENSION)w;
  c.image_height = (JDIMENSION)h;
  c.input_components = channels;
  c.in_color_space = channels == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, quality, TRUE);
  if (channels == 3) {
    c.comp_info[0].h_samp_factor = h_samp;
    c.comp_info[0].v_samp_factor = v_samp;
  }
  if (dac) {                         /* L, U and Kx of every table */
    int t;
    for (t = 0; t < NUM_ARITH_TBLS; ++t) {
      c.arith_dc_L[t] = (UINT8)dac[0];
      c.arith_dc_U[t] = (UINT8)dac[1];
      c.arith_ac_K[t] = (UINT8)dac[2];
    }
  }
  jw_options(&c, progressive, arithmetic, restart, scans, n_scans, info);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    row = (JSAMPROW)(pixels + (size_t)c.next_scanline * w * channels);
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  free(info);
  return 0;
}

int jw_transcode(const unsigned char *data, unsigned long len, int progressive,
                 int arithmetic, int restart, const int *scans, int n_scans,
                 unsigned char **out, unsigned long *out_len) {
  struct jpeg_decompress_struct d;
  struct jpeg_compress_struct c;
  struct jw_error err;               /* one error manager for both */
  jpeg_scan_info *info =
      (jpeg_scan_info *)calloc(n_scans > 0 ? n_scans : 1, sizeof *info);
  jvirt_barray_ptr *coefs;
  memset(&d, 0, sizeof d);
  memset(&c, 0, sizeof c);
  *out = NULL;
  *out_len = 0;
  d.err = c.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = jw_error_exit;
  if (setjmp(err.jump)) {
    jpeg_destroy_compress(&c);
    jpeg_destroy_decompress(&d);
    free(info);
    *out = NULL;                     /* may be stale: leaked, not freed */
    return 1;
  }
  jpeg_create_decompress(&d);
  jpeg_create_compress(&c);
  jpeg_mem_src(&d, data, len);
  jpeg_read_header(&d, TRUE);
  coefs = jpeg_read_coefficients(&d);
  jpeg_mem_dest(&c, out, out_len);
  jpeg_copy_critical_parameters(&d, &c);
  jw_options(&c, progressive, arithmetic, restart, scans, n_scans, info);
  jpeg_write_coefficients(&c, coefs);
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  jpeg_finish_decompress(&d);
  jpeg_destroy_decompress(&d);
  free(info);
  return 0;
}

void jw_free(unsigned char *p) { free(p); }

#ifdef __cplusplus
}
#endif
