/* A JPEG writer for the port's decoder tests, on the libjpeg-turbo 3 that
 * Pillow bundles (pillow.libs/libjpeg-*.so.62.4.0): what
 * tests/torch_jpeg_writer.c cannot write on the system's libjpeg-turbo 2,
 * namely lossless frames (jpeg_enable_lossless: SOF3, or SOF11 with
 * arithmetic coding), and four-component files (CMYK, YCCK) with any
 * sampling, coding and scan script, with or without their Adobe marker.
 * tests/torch_pillow_corpus.py builds it at first use with
 *
 *   g++ -O2 -fPIC -shared -o libpillow_jpeg_writer.so \
 *       torch_pillow_jpeg_writer.c <pillow.libs>/libjpeg-*.so.62.4.0
 *
 * (the system's jpeglib.h: the two libraries share the version 62 API)
 * and binds it through ctypes. A call returns 0 and a malloc'd buffer
 * (free it with pw_free), or nonzero where libjpeg stops.
 *
 * samp holds h, v for each component. A scan script is n_scans rows of 9
 * ints, as in tests/torch_jpeg_writer.c. psv 0 writes DCT frames; psv 1-7
 * a lossless frame with that predictor and point transform pt.
 */
#include <setjmp.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

#ifdef __cplusplus
extern "C" {
#endif

/* libjpeg-turbo 3's, absent from the version 2 header */
void jpeg_enable_lossless(j_compress_ptr cinfo, int predictor_selection_value,
                          int point_transform);

struct pw_error {
  struct jpeg_error_mgr pub;
  jmp_buf jump;
};

static void pw_error_exit(j_common_ptr cinfo) {
  longjmp(((struct pw_error *)cinfo->err)->jump, 1);
}

int pw_encode(const unsigned char *pixels, int h, int w, int components,
              int in_space, int jpeg_space, const int *samp, int quality,
              int progressive, int arithmetic, int restart, const int *scans,
              int n_scans, int adobe, int psv, int pt, unsigned char **out,
              unsigned long *out_len) {
  struct jpeg_compress_struct c;
  struct pw_error err;
  jpeg_scan_info *info =
      (jpeg_scan_info *)calloc(n_scans > 0 ? n_scans : 1, sizeof *info);
  JSAMPROW row;
  int i, k;
  memset(&c, 0, sizeof c);
  *out = NULL;
  *out_len = 0;
  c.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = pw_error_exit;
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
  c.input_components = components;
  c.in_color_space = (J_COLOR_SPACE)in_space;
  jpeg_set_defaults(&c);
  if (psv > 0) {
    jpeg_enable_lossless(&c, psv, pt);
  } else {
    jpeg_set_quality(&c, quality, TRUE);
  }
  jpeg_set_colorspace(&c, (J_COLOR_SPACE)jpeg_space);
  for (i = 0; i < components; ++i) {
    c.comp_info[i].h_samp_factor = samp[2 * i];
    c.comp_info[i].v_samp_factor = samp[2 * i + 1];
  }
  if (adobe >= 0) c.write_Adobe_marker = adobe ? TRUE : FALSE;
  c.arith_code = arithmetic ? TRUE : FALSE;
  c.restart_interval = (unsigned int)restart;
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
    c.scan_info = info;
    c.num_scans = n_scans;
  } else if (progressive) {
    jpeg_simple_progression(&c);
  }
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    row = (JSAMPROW)(pixels + (size_t)c.next_scanline * w * components);
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  free(info);
  return 0;
}

void pw_free(unsigned char *p) { free(p); }

#ifdef __cplusplus
}
#endif
