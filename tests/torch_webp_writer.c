/* A WebP writer for the port's decoder tests, on the libwebp 1.6.0 that
 * Pillow bundles (pillow.libs/libwebp-*.so.7.2.0), with every WebPConfig
 * field Pillow's writer does not expose: the simple loop filter, the
 * filter's strength and sharpness, token partitions, segments, spatial
 * noise shaping, the alpha plane's compression, filtering and quality.
 * tests/torch_webp_corpus.py builds it at first use with
 *
 *   g++ -O2 -fPIC -shared -o libwebp_writer.so torch_webp_writer.c \
 *       <pillow.libs>/libwebp-*.so.7.2.0
 *
 * (the system's webp/encode.h: the encoder ABI's major version is shared)
 * and binds it through ctypes. A call returns 0 and a malloc'd RIFF file
 * (free it with ww_free), or nonzero where libwebp refuses the settings or
 * the picture.
 *
 * settings, in order: lossless, quality, method, filter_type,
 * filter_strength, filter_sharpness, partitions (log2), segments,
 * sns_strength, alpha_compression, alpha_filtering, alpha_quality, exact.
 * rgba is h x w x 4; has_alpha 0 imports only its RGB.
 */
#include <stdlib.h>
#include <string.h>

#include <webp/encode.h>

#ifdef __cplusplus
extern "C" {
#endif

int ww_encode(const uint8_t* rgba, int h, int w, int has_alpha,
              const int* settings, uint8_t** out, size_t* out_size) {
  WebPConfig config;
  WebPPicture pic;
  WebPMemoryWriter writer;
  int ok;
  if (!WebPConfigInit(&config)) return 1;
  config.lossless = settings[0];
  config.quality = (float)settings[1];
  config.method = settings[2];
  config.filter_type = settings[3];
  config.filter_strength = settings[4];
  config.filter_sharpness = settings[5];
  config.partitions = settings[6];
  config.segments = settings[7];
  config.sns_strength = settings[8];
  config.alpha_compression = settings[9];
  config.alpha_filtering = settings[10];
  config.alpha_quality = settings[11];
  config.exact = settings[12];
  config.autofilter = 0;
  if (!WebPValidateConfig(&config)) return 2;
  if (!WebPPictureInit(&pic)) return 3;
  pic.use_argb = config.lossless;
  pic.width = w;
  pic.height = h;
  if (has_alpha) {
    ok = WebPPictureImportRGBA(&pic, rgba, 4 * w);
  } else {
    ok = WebPPictureImportRGBX(&pic, rgba, 4 * w);
  }
  if (!ok) return 4;
  WebPMemoryWriterInit(&writer);
  pic.writer = WebPMemoryWrite;
  pic.custom_ptr = &writer;
  ok = WebPEncode(&config, &pic);
  WebPPictureFree(&pic);
  if (!ok) {
    WebPMemoryWriterClear(&writer);
    return 5;
  }
  *out = writer.mem;
  *out_size = writer.size;
  return 0;
}

void ww_free(uint8_t* p) { WebPFree(p); }

#ifdef __cplusplus
}
#endif
