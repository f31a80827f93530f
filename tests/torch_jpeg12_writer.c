/* The tests' 12-bit JPEG writer: libjpeg-turbo 3.1.3 (Pillow 12.1.0's
 * bundled pillow.libs/libjpeg-*.so.62.4.0, built against the system's
 * jpeglib.h, whose structures it shares) compressing 12-bit grey samples
 * with jpeg12_write_scanlines: baseline at a quality, progressive
 * (jpeg_simple_progression), arithmetic coding, optimized Huffman tables,
 * restart intervals, lossless (a predictor and a point transform).
 *
 * j12_write(px, w, h, quality, progressive, arith, optimize, restart,
 * lossless, pt, out, cap): px holds h rows of w samples (0-4095); the
 * stream goes to out (cap bytes). Returns its length, or -1 where libjpeg
 * refuses or the stream does not fit.
 */
#include <setjmp.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

typedef short J12SAMPLE;
typedef J12SAMPLE *J12SAMPROW;
typedef J12SAMPROW *J12SAMPARRAY;
extern JDIMENSION jpeg12_write_scanlines(j_compress_ptr, J12SAMPARRAY,
                                         JDIMENSION);
extern void jpeg_enable_lossless(j_compress_ptr, int, int);

struct err {
  struct jpeg_error_mgr pub;
  jmp_buf jb;
};

static void on_error(j_common_ptr c) { longjmp(((struct err *)c->err)->jb, 1); }

long j12_write(const short *px, int w, int h, int quality, int progressive,
               int arith, int optimize, int restart, int lossless, int pt,
               unsigned char *out, long cap) {
  struct jpeg_compress_struct c;
  struct err e;
  unsigned char *mem = NULL;
  unsigned long len = 0;
  c.err = jpeg_std_error(&e.pub);
  e.pub.error_exit = on_error;
  if (setjmp(e.jb)) {
    jpeg_destroy_compress(&c);
    free(mem);
    return -1;
  }
  jpeg_create_compress(&c);
  jpeg_mem_dest(&c, &mem, &len);
  c.image_width = w;
  c.image_height = h;
  c.input_components = 1;
  c.in_color_space = JCS_GRAYSCALE;
  c.data_precision = 12;
  jpeg_set_defaults(&c);
  c.data_precision = 12;
  if (lossless) {
    jpeg_enable_lossless(&c, lossless, pt);
  } else {
    jpeg_set_quality(&c, quality, TRUE);
    if (progressive) jpeg_simple_progression(&c);
  }
  c.arith_code = arith;
  c.optimize_coding = optimize;
  c.restart_interval = restart;
  jpeg_start_compress(&c, TRUE);
  for (int y = 0; y < h; ++y) {
    J12SAMPROW row = (J12SAMPROW)(px + (long)y * w);
    jpeg12_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  long n = (long)len;
  if (n > cap)
    n = -1;
  else
    memcpy(out, mem, len);
  free(mem);
  return n;
}
