"""Host-side image decode, size reading, resize, letterbox and the C ops
of the training augmentation.

Port of ``yolov5m_tpu/data/native.py``. The resize, the letterbox's
padding, the image decoders and the augmentation's image ops run in the
port's own C library, built at first use with ``g++`` and the JAX
package's Makefile flags into ``build/yolov5m_tpu_torch/`` from sixteen
sources: ``csrc/preprocess.cc`` (a copy of the JAX package's resize and
letterbox), ``csrc/jpeg_decode.cc`` (the port's JPEG decoder, which
computes what the JAX package's libjpeg call computes, bit for bit, and
needs no libjpeg; in its second mode what Pillow's JPEG decode computes,
in its third what libtiff's JPEG codec computes under Pillow's TIFF
decoder),
``csrc/png_decode.cc`` (PNG as Pillow decodes it; the inflate between its
calls is Python's zlib), ``csrc/bmp_decode.cc`` and ``csrc/gif_decode.cc``
(BMP and a GIF's first frame as Pillow decodes them),
``csrc/webp_decode.cc`` (a WebP's first frame as Pillow decodes it over
libwebp 1.6.0: VP8, VP8L, ALPH, animations), ``csrc/pnm_decode.cc`` (the
token scan of plain PGM and PPM, for data/pnm.py), ``csrc/tiff_decode.cc``
(libtiff's PackBits, LZW, ThunderScan, predictors and TIFFRGBAImage's
YCbCr putters, for data/tiff.py), ``csrc/fax_decode.cc`` (libtiff's CCITT
fax decoders), ``csrc/zstd_decode.cc`` and ``csrc/xz_decode.cc``
(libtiff's ZSTD and LZMA codecs over libzstd 1.5.7, legacy frames
included, and liblzma 5.8.2, as libtiff drives them),
``csrc/lab_convert.cc`` (LittleCMS's Lab to sRGB transform of Pillow's
``convert("RGB")`` of a LAB image), ``csrc/j2k_decode.cc`` (JPEG 2000 as
Pillow's Jpeg2KDecode.c drives OpenJPEG 2.5.4, for data/jpeg2k.py),
``csrc/raster_decode.cc`` (the byte loops of Pillow's PCX, TGA and SGI
RLE, MSP, QOI, XBM and bit decoders, for data/raster.py),
``csrc/augment.cc``
(the cv2 calls of the JAX package's augmentation: rotate, blur, HSV, Lab,
CLAHE and the mosaic's 2x downscale) and ``csrc/plot.cc`` (the pixel work
of the prediction images, utils/plotting.py). It is called through
ctypes, which releases the GIL for the length of each call, so loader
threads resize, decode and augment at once.

The decode follows the JAX package's routes. ``decode_image`` and
``load_image_rgb`` (the server, the loader, detect ``--img_dir``) decode a
JPEG as the JAX package's libjpeg-turbo 2.1 does, and one it refuses as
Pillow 12.1.0 does over its libjpeg-turbo 3.1.3 (CMYK, YCCK, lossless, and
a file cut short refused); ``load_image_pillow`` (detect ``--img``) decodes
every JPEG the second way, as the JAX package's ``Image.open`` does. PNG,
BMP, GIF and WebP decode as Pillow decodes them, PNM (P1-P6 at every
maxval, ``Pf`` and Pillow's extensions) as Pillow's PPM plugin reads it
(``data/pnm.py``: Python and numpy, the plain files' token scan in C), and
TIFF of every compression Pillow's open knows (uncompressed, LZW,
deflate, PackBits, JPEG at 8 and 12 bits, old-style JPEG, ZSTD, LZMA,
CCITT fax, ThunderScan; YCbCr and CIELab among it), as Pillow's TIFF
plugin reads it over libtiff (``data/tiff.py``; the codecs, predictors
and YCbCr putters in ``csrc/tiff_decode.cc``, the fax codecs in
``csrc/fax_decode.cc``, the JPEG and old-style JPEG codecs in
``csrc/jpeg_decode.cc``, ZSTD and LZMA in ``csrc/zstd_decode.cc`` and
``csrc/xz_decode.cc``; WebP and SGILog in TIFF refused where Pillow
refuses them), and JPEG 2000 (J2K and JP2) as Pillow's JPEG 2000 plugin
reads it over OpenJPEG 2.5.4 (``data/jpeg2k.py``, ``csrc/j2k_decode.cc``),
and DIB, ICO, CUR, PCX, DCX, MSP, QOI, SGI, SPIDER, TGA, XBM and IM as
Pillow's plugins read them (``data/raster.py``); sizes are read as
Pillow's open reads them (a WebP's from its whole file, which Pillow's
open demuxes; a TIFF's from IFD0, wherever it lies; an ICO's from the
entry its open loads). Each file goes to the plugin Pillow's
``Image.open`` picks, in Pillow's order (``data/formats.py``: every
plugin's accept function, the opens of those the port reads, the header
checks of those it does not), never by its name. A file that a plugin
the port does not read opens (the long tail, and JPEG 2000 files whose
markers name HTJ2K code-blocks or Part 2's MCT) goes to PIL where it is
installed; one that no plugin opens is refused. Where the library cannot
be built, the C decoders raise naming the compiler.

``resize_bilinear_plain`` and ``letterbox_plain`` are the numpy versions
the C path is held against. They run where the library cannot be built
(a warning says so, once), and for images the C path does not take: a
grayscale (h, w) image. They follow the C code's float32 formula:

  fy = clamp((y + 0.5f) * (sh / dh) - 0.5f, 0, sh - 1),  y0 = (int) fy,
  ty = fy - y0,  lerp(a, b, t) = a + t * (b - a),  out = (uint8)(v + 0.5f)

The C build may contract a lerp into an FMA, so where a resize happens the
two can differ by one code in a pixel.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import io
import os
import platform
import subprocess
import tempfile
import threading
import time
import warnings
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

from yolov5m_tpu_torch.data import formats, jpeg2k, pnm, raster, tiff

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "preprocess.cc")
JPEG_SOURCE = os.path.join(_PKG_DIR, "csrc", "jpeg_decode.cc")
PNG_SOURCE = os.path.join(_PKG_DIR, "csrc", "png_decode.cc")
BMP_SOURCE = os.path.join(_PKG_DIR, "csrc", "bmp_decode.cc")
GIF_SOURCE = os.path.join(_PKG_DIR, "csrc", "gif_decode.cc")
WEBP_SOURCE = os.path.join(_PKG_DIR, "csrc", "webp_decode.cc")
PNM_SOURCE = os.path.join(_PKG_DIR, "csrc", "pnm_decode.cc")
TIFF_SOURCE = os.path.join(_PKG_DIR, "csrc", "tiff_decode.cc")
FAX_SOURCE = os.path.join(_PKG_DIR, "csrc", "fax_decode.cc")
ZSTD_SOURCE = os.path.join(_PKG_DIR, "csrc", "zstd_decode.cc")
XZ_SOURCE = os.path.join(_PKG_DIR, "csrc", "xz_decode.cc")
LAB_SOURCE = os.path.join(_PKG_DIR, "csrc", "lab_convert.cc")
J2K_SOURCE = os.path.join(_PKG_DIR, "csrc", "j2k_decode.cc")
RASTER_SOURCE = os.path.join(_PKG_DIR, "csrc", "raster_decode.cc")
AUGMENT_SOURCE = os.path.join(_PKG_DIR, "csrc", "augment.cc")
PLOT_SOURCE = os.path.join(_PKG_DIR, "csrc", "plot.cc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "yolov5m_tpu_torch")
CXX = "g++"
# the JAX package's Makefile (yolov5m_tpu/_native_src/Makefile), whose
# rule is $(CXX) $(CXXFLAGS) -shared -o $@ $< -ljpeg; the port links no
# libjpeg
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-Wall",
             "-Wextra")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()
build_seconds = None   # wall time of the g++ build, when this process built
build_command = ""     # the compile line of the library that was loaded


def _sources() -> tuple:
    return (AUGMENT_SOURCE, PNG_SOURCE, PLOT_SOURCE, BMP_SOURCE, GIF_SOURCE,
            WEBP_SOURCE, PNM_SOURCE, TIFF_SOURCE, FAX_SOURCE, ZSTD_SOURCE,
            XZ_SOURCE, LAB_SOURCE, J2K_SOURCE, RASTER_SOURCE, SOURCE,
            JPEG_SOURCE)


def _command(out: str) -> list:
    return [CXX, *CXX_FLAGS, "-shared", "-o", out, *_sources()]


def library_path() -> str:
    """The library's file: named by a digest of the sources, the compile
    line and the host (-march=native code built on one host must not load
    on another that sees the same directory)."""
    digest = hashlib.sha256()
    for source in _sources():
        with open(source, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join([*_command(""), platform.node(),
                            platform.machine()]).encode())
    return os.path.join(BUILD_DIR, f"libpreproc_{digest.hexdigest()[:16]}.so")


def _compile() -> str:
    """Build the library unless its file exists: under an exclusive lock on
    a file beside the build directory (BUILD_DIR.lock, so the directory
    holds libraries alone), held across the check and the build, so that
    processes starting at once run the compiler once and the others load
    its output; to a temporary name, then renamed into place, so that no
    process loads a half-written file. Raises RuntimeError with g++'s
    output."""
    global build_seconds
    path = library_path()
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(f"{BUILD_DIR}.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.isfile(path):          # built while this one waited
            return path
        tmp = f"{path}.tmp.{os.getpid()}"
        t0 = time.perf_counter()
        try:
            _run_command(tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    build_seconds = time.perf_counter() - t0
    return path


def _run(command: list) -> None:
    proc = subprocess.run(command, capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{CXX} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")


def _run_command(out: str) -> None:
    """Run _command(out) as g++ runs it, one compile per source and then
    the link, with the compiles started together, one a core (the line
    itself compiles one source after another)."""
    sources = _sources()
    with tempfile.TemporaryDirectory() as tmp:
        objects = [os.path.join(tmp, f"{os.path.basename(s)}.o")
                   for s in sources]
        workers = min(len(sources), os.cpu_count() or 1)
        with ThreadPoolExecutor(workers) as pool:
            for done in [pool.submit(_run, [CXX, *CXX_FLAGS, "-c", s, "-o", o])
                         for s, o in zip(sources, objects)]:
                done.result()
        _run([CXX, *CXX_FLAGS, "-shared", "-o", out, *objects])


def build() -> ctypes.CDLL:
    """Build (if needed) and load the library; returns the CDLL. A
    compiler error raises RuntimeError."""
    global _lib, build_command
    with _lock:
        if _lib is not None:
            return _lib
        path = _compile()
        build_command = " ".join(_command(path))
        lib = ctypes.CDLL(path)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.resize_bilinear_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, u8p, ctypes.c_int,
                                           ctypes.c_int]
        lib.resize_bilinear_u8.restype = None
        lib.letterbox_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, u8p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_uint8]
        lib.letterbox_u8.restype = None
        ip = ctypes.POINTER(ctypes.c_int)
        lib.jpeg_dims.argtypes = [u8p, ctypes.c_int64, ip, ip]
        lib.jpeg_dims.restype = ctypes.c_int
        lib.decode_jpeg_u8.argtypes = [u8p, ctypes.c_int64, u8p,
                                       ctypes.c_int, ctypes.c_int]
        lib.decode_jpeg_u8.restype = ctypes.c_int
        lib.jpeg_dims_mode.argtypes = [u8p, ctypes.c_int64, ip, ip,
                                       ctypes.c_int]
        lib.decode_jpeg_u8_mode.argtypes = [u8p, ctypes.c_int64, u8p,
                                            ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int]
        for name in ("bmp", "gif", "webp"):
            getattr(lib, f"{name}_dims").argtypes = [u8p, ctypes.c_int64, ip,
                                                     ip]
            getattr(lib, f"decode_{name}_u8").argtypes = [
                u8p, ctypes.c_int64, u8p, ctypes.c_int, ctypes.c_int]
        lib.decode_webp_rgba_u8.argtypes = lib.decode_webp_u8.argtypes
        lib.pnm_plain_tokens.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32)]
        lib.pnm_plain_tokens.restype = ctypes.c_int64
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.tiff_decode_chunks.argtypes = [
            u8p, i64p, i64p, i64p, ctypes.c_int64, u8p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int64, i64p]
        lib.tiff_decode_chunks.restype = ctypes.c_int64
        i32p_ = ctypes.POINTER(ctypes.c_int32)
        lib.fax_tiff_chunks.argtypes = [
            u8p, i64p, i64p, i64p, ctypes.c_int64, u8p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, i32p_]
        lib.fax_tiff_chunks.restype = None
        lib.j2k_decode.argtypes = [u8p, ctypes.c_int64, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   u8p]
        lib.j2k_decode.restype = ctypes.c_int
        lib.j2k_tiles.argtypes = [u8p, ctypes.c_int64, ctypes.c_int, u8p,
                                  ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.j2k_tiles.restype = ctypes.c_int
        lib.j2k_ycbcr_rgb.argtypes = [u8p, ctypes.c_int64]
        lib.j2k_ycbcr_rgb.restype = None
        i64_ = ctypes.c_int64
        lib.dib_dims.argtypes = [u8p, i64_, ip, ip, i64_, ctypes.c_int]
        lib.decode_dib_u8.argtypes = [u8p, i64_, u8p, ctypes.c_int,
                                      ctypes.c_int, i64_, ctypes.c_int]
        lib.pcx_rows.argtypes = [u8p, i64_, i64_, i64_, i64_, i64_, i64_,
                                 u8p]
        lib.tga_rle_rows.argtypes = [u8p, i64_, i64_, i64_, i64_, i64_, u8p]
        lib.sgi_rle.argtypes = [u8p, i64_, i64_, i64_, i64_, i64_,
                                ctypes.c_int, u8p]
        lib.msp_rows.argtypes = [u8p, i64_, i64_, i64_, u8p, i64_]
        lib.msp_rows.restype = i64_
        lib.qoi_decode.argtypes = [u8p, i64_, i64_, i64_, i64_, ctypes.c_int,
                                   u8p]
        lib.xbm_rows.argtypes = [u8p, i64_, i64_, i64_, i64_, u8p]
        lib.bit_decode.argtypes = [u8p, i64_, i64_, i64_, i64_, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_float)]
        for name in ("dib_dims", "decode_dib_u8", "pcx_rows", "tga_rle_rows",
                     "sgi_rle", "qoi_decode", "xbm_rows", "bit_decode"):
            getattr(lib, name).restype = ctypes.c_int
        lib.tiff_jpeg_chunks.argtypes = [
            u8p, u8p, ctypes.c_int64, i64p, i64p, i64p, i32p_, i64p,
            ctypes.c_int64, u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p_]
        lib.tiff_jpeg_chunks.restype = None
        lib.tiff_ojpeg_subsampling.argtypes = [
            u8p, i64p, i64p, i64p, ctypes.c_int64, i32p_]
        lib.tiff_ojpeg_subsampling.restype = None
        lib.tiff_ojpeg_reads.argtypes = [
            u8p, i64p, i64p, i64p, ctypes.c_int64, i64p, i64p, ctypes.c_int64,
            u8p, ctypes.c_int64, i32p_]
        lib.tiff_ojpeg_reads.restype = None
        fp_ = ctypes.POINTER(ctypes.c_float)
        lib.tiff_ycbcr_tables.argtypes = [fp_, fp_, i32p_]
        lib.tiff_ycbcr_tables.restype = ctypes.c_int
        lib.tiff_ycbcr_put.argtypes = [
            i32p_, u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int]
        lib.tiff_ycbcr_put.restype = ctypes.c_int
        lib.tiff_ycbcr_put_separate.argtypes = [
            i32p_, u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p, u8p, u8p,
            ctypes.c_int64]
        lib.tiff_ycbcr_put_separate.restype = ctypes.c_int
        vp_ = ctypes.c_void_p
        lib.lcms_lab_clut.argtypes = [vp_]
        lib.lcms_lab_to_rgb.argtypes = [vp_, ctypes.c_int64, vp_, vp_]
        for name in ("lcms_lab_clut", "lcms_lab_to_rgb"):
            getattr(lib, name).restype = None
        for name in ("jpeg_dims_mode", "decode_jpeg_u8_mode", "bmp_dims",
                     "decode_bmp_u8", "gif_dims", "decode_gif_u8",
                     "webp_dims", "decode_webp_u8", "decode_webp_rgba_u8"):
            getattr(lib, name).restype = ctypes.c_int
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64 = ctypes.c_int64
        lib.png_header.argtypes = [u8p, i64, i32p, u8p]
        lib.png_header.restype = i64
        lib.png_dims.argtypes = [u8p, i64, ip, ip]
        lib.png_dims.restype = ctypes.c_int
        lib.png_idat.argtypes = [u8p, i64, i64, ctypes.POINTER(i64)]
        lib.png_idat.restype = i64
        lib.png_tail.argtypes = [u8p, i64, i64]
        lib.png_tail.restype = ctypes.c_int
        lib.png_raw_size.argtypes = [i32p]
        lib.png_raw_size.restype = i64
        lib.png_to_rgb.argtypes = [u8p, i32p, u8p, u8p]
        lib.png_to_rgb.restype = ctypes.c_int
        fp = ctypes.POINTER(ctypes.c_float)
        dp = ctypes.POINTER(ctypes.c_double)
        c_int = ctypes.c_int
        lib.warp_affine_linear_f32.argtypes = [fp, c_int, c_int, dp, fp,
                                               c_int, c_int]
        lib.box_blur_f32.argtypes = [fp, c_int, c_int, c_int, fp]
        for name in ("rgb_to_hsv_u8", "hsv_to_rgb_u8", "rgb_to_lab_u8",
                     "lab_to_rgb_u8"):
            getattr(lib, name).argtypes = [u8p, i64, c_int, u8p]
        lib.clahe_u8.argtypes = [u8p, c_int, c_int, ctypes.c_double, c_int,
                                 c_int, u8p]
        lib.downscale2x_linear_f32.argtypes = [fp, c_int, c_int, fp]
        vp, c_double = ctypes.c_void_p, ctypes.c_double
        lib.plot_glyphs.argtypes = [vp, vp, vp, c_int, c_int, c_int, vp,
                                    c_int, c_int]
        lib.plot_path.argtypes = [vp, c_int, c_int, c_double, vp, vp, c_int,
                                  dp, dp, c_double, dp, c_int, dp]
        lib.plot_markers.argtypes = [vp, c_int, c_int, c_double, vp, c_int,
                                     dp, vp, c_int, dp, c_double, dp, c_int]
        lib.plot_text_image.argtypes = [vp, c_int, c_int, vp, c_int, c_int,
                                        c_int, c_int, dp]
        lib.plot_resample.argtypes = [vp, c_int, c_int, vp, c_int, c_int, dp,
                                      c_int, c_int]
        lib.plot_blend_image.argtypes = [vp, c_int, c_int, vp, c_int, c_int,
                                         c_int, c_int, dp]
        for name in ("warp_affine_linear_f32", "box_blur_f32",
                     "rgb_to_hsv_u8", "hsv_to_rgb_u8", "rgb_to_lab_u8",
                     "lab_to_rgb_u8", "clahe_u8", "downscale2x_linear_f32",
                     "plot_glyphs", "plot_path", "plot_markers",
                     "plot_text_image", "plot_resample", "plot_blend_image"):
            getattr(lib, name).restype = None
        _lib = lib
        return lib


def _load_lib() -> Optional[ctypes.CDLL]:
    """The library, or None where it cannot be built: the first failure
    warns, and the numpy versions run from then on."""
    global _tried
    if _lib is not None or _tried:
        return _lib
    try:
        return build()
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        with _lock:
            if not _tried:
                warnings.warn(
                    f"native preprocessing library unavailable "
                    f"({type(e).__name__}: {e}); using the numpy resize and "
                    f"letterbox (slower, and they hold the GIL)")
            _tried = True
        return None


def native_available() -> bool:
    """True when the C library is built and loaded."""
    return _load_lib() is not None


def jpeg_available() -> bool:
    """True when the C library, and with it the JPEG decoder, is built."""
    return native_available()


def _as_u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _as_fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


# -- augmentation ops ---------------------------------------------------------
#
# The cv2 calls of the JAX package's host augmentation (csrc/augment.cc).
# They have no numpy version: where the library cannot be built they raise.

def augment_lib() -> ctypes.CDLL:
    """The library, for the augmentation's ops. Raises RuntimeError naming
    the compiler where it cannot be built."""
    try:
        return build()
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        raise RuntimeError(
            f"the port's augmentation ops (rotate, blur, CLAHE, HSV, the "
            f"mosaic's downscale) need its C library, built with {CXX} from "
            f"{AUGMENT_SOURCE}: {type(e).__name__}: {e}") from e


def decode_lib() -> ctypes.CDLL:
    """The library, for the image decoders. Raises RuntimeError naming the
    compiler where it cannot be built: a decode has no other version."""
    try:
        return build()
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        raise RuntimeError(
            f"the port's image decoders need its C library, built with "
            f"{CXX} from {JPEG_SOURCE} and the other sources in its folder: "
            f"{type(e).__name__}: {e}") from e


def plot_lib() -> ctypes.CDLL:
    """The library, for the prediction images' rasterizer (csrc/plot.cc).
    Raises RuntimeError naming the compiler where it cannot be built."""
    try:
        return build()
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        raise RuntimeError(
            f"the port's prediction images need its C library, built with "
            f"{CXX} from {PLOT_SOURCE}: {type(e).__name__}: {e}") from e


def _rgb(img: np.ndarray, dtype) -> np.ndarray:
    a = np.ascontiguousarray(img, dtype)
    if a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"expected an (h, w, 3) image, got {a.shape}")
    return a


def warp_affine(img: np.ndarray, m: np.ndarray,
                size_wh: Tuple[int, int]) -> np.ndarray:
    """cv2.warpAffine(img float32, m, size_wh, INTER_LINEAR, borderValue=0)
    of an (h, w, 3) image through the forward 2x3 matrix m."""
    lib = augment_lib()
    src = _rgb(img, np.float32)
    w, h = int(size_wh[0]), int(size_wh[1])
    mm = np.ascontiguousarray(m, np.float64).reshape(6)
    dst = np.empty((h, w, 3), np.float32)
    lib.warp_affine_linear_f32(
        _as_fp(src), src.shape[0], src.shape[1],
        mm.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), _as_fp(dst), h, w)
    return dst


def box_blur(img: np.ndarray, k: int) -> np.ndarray:
    """cv2.blur(img float32, (k, k)) of an (h, w, 3) image, k odd."""
    if k < 1 or k % 2 == 0:
        raise ValueError(f"box_blur takes an odd window, got {k}")
    lib = augment_lib()
    src = _rgb(img, np.float32)
    dst = np.empty_like(src)
    lib.box_blur_f32(_as_fp(src), src.shape[0], src.shape[1], int(k),
                     _as_fp(dst))
    return dst


def _convert(name: str, img: np.ndarray) -> np.ndarray:
    lib = augment_lib()
    src = _rgb(img, np.uint8)
    dst = np.empty_like(src)
    getattr(lib, name)(_as_u8p(src), src.shape[0], src.shape[1],
                       _as_u8p(dst))
    return dst


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img uint8, COLOR_RGB2HSV): hue 0..180."""
    return _convert("rgb_to_hsv_u8", img)


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img uint8, COLOR_HSV2RGB), which rounds otherwise at
    the end of each row."""
    return _convert("hsv_to_rgb_u8", img)


def rgb_to_lab(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img uint8, COLOR_RGB2LAB)."""
    return _convert("rgb_to_lab_u8", img)


def lab_to_rgb(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img uint8, COLOR_LAB2RGB)."""
    return _convert("lab_to_rgb_u8", img)


_lab_table: Optional[np.ndarray] = None


def lab_to_srgb(samples: np.ndarray) -> np.ndarray:
    """Pillow's ``convert("RGB")`` of LAB storage ((h, w, >= 3) uint8: L,
    a + 128, b + 128): LittleCMS's 16-bit table of its Lab-to-sRGB
    transform, computed by csrc/lab_convert.cc at first use, interpolated
    in C on one thread. (h, w, 3) uint8."""
    global _lab_table
    lib = decode_lib()
    with _lock:
        if _lab_table is None:
            table = np.empty(33 * 33 * 33 * 3, np.uint16)
            lib.lcms_lab_clut(table.ctypes.data)
            _lab_table = table
    h, w = samples.shape[:2]
    px = np.zeros((h, w, 4), np.uint8)
    px[..., :3] = samples[..., :3]
    out = np.empty((h, w, 3), np.uint8)
    lib.lcms_lab_to_rgb(px.ctypes.data, h * w, _lab_table.ctypes.data,
                        out.ctypes.data)
    return out


def clahe(plane: np.ndarray, clip_limit: float = 4.0,
          tiles: Tuple[int, int] = (8, 8)) -> np.ndarray:
    """cv2.createCLAHE(clip_limit, tiles).apply(plane) of an (h, w) uint8
    plane; tiles is (across, down), as cv2's tileGridSize."""
    lib = augment_lib()
    src = np.ascontiguousarray(plane, np.uint8)
    if src.ndim != 2:
        raise ValueError(f"expected an (h, w) plane, got {src.shape}")
    if min(tiles) < 1:
        raise ValueError(f"clahe takes at least one tile a side, got {tiles}")
    dst = np.empty_like(src)
    lib.clahe_u8(_as_u8p(src), src.shape[0], src.shape[1],
                 float(clip_limit), int(tiles[0]), int(tiles[1]),
                 _as_u8p(dst))
    return dst


def downscale2x(img: np.ndarray) -> np.ndarray:
    """cv2.resize(img float32, (w // 2, h // 2), INTER_LINEAR) of an
    (h, w, 3) image with h and w even: each pixel lerps its 2x2 block."""
    lib = augment_lib()
    src = _rgb(img, np.float32)
    h, w = src.shape[:2]
    if h % 2 or w % 2:
        raise ValueError(f"downscale2x takes even sizes, got {src.shape}")
    dst = np.empty((h // 2, w // 2, 3), np.float32)
    lib.downscale2x_linear_f32(_as_fp(src), h, w, _as_fp(dst))
    return dst


# -- resize and letterbox -----------------------------------------------------

_F = np.float32


def _axis(src: int, dst: int):
    """Source indices (i0, i1) and f32 weights for one axis (C formula)."""
    scale = _F(src) / _F(dst)
    f = (np.arange(dst, dtype=_F) + _F(0.5)) * scale - _F(0.5)
    f = np.minimum(np.maximum(f, _F(0.0)), _F(src - 1))
    i0 = f.astype(np.int64)
    i1 = np.minimum(i0 + 1, src - 1)
    return i0, i1, f - i0.astype(_F)


def _lerp(a, b, t):
    return a + t * (b - a)


def resize_bilinear_plain(img: np.ndarray,
                          size_wh: Tuple[int, int]) -> np.ndarray:
    """The numpy resize: an (h, w, c) or (h, w) uint8 image to (w, h),
    half-pixel centers, no antialiasing, rounded half up."""
    w, h = int(size_wh[0]), int(size_wh[1])
    if img.shape[0] == h and img.shape[1] == w:
        return img
    sh, sw = img.shape[:2]
    y0, y1, ty = _axis(sh, h)
    x0, x1, tx = _axis(sw, w)
    f = np.asarray(img, np.uint8).astype(_F)
    gray = f.ndim == 2
    if gray:
        f = f[..., None]
    ty, tx = ty[:, None, None], tx[None, :, None]
    top = _lerp(f[y0][:, x0], f[y0][:, x1], tx)
    bot = _lerp(f[y1][:, x0], f[y1][:, x1], tx)
    out = (_lerp(top, bot, ty) + _F(0.5)).astype(np.uint8)
    return out[..., 0] if gray else out


def _c_path(img: np.ndarray) -> Optional[ctypes.CDLL]:
    """The library, where it takes this image: (h, w, c) uint8."""
    if img.ndim != 3 or img.dtype != np.uint8:
        return None
    return _load_lib()


def resize_bilinear(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an (h, w, c) or (h, w) uint8 image to (w, h):
    half-pixel centers, no antialiasing, rounded half up. (h, w, c) images
    go through the C library."""
    w, h = int(size_wh[0]), int(size_wh[1])
    if img.shape[0] == h and img.shape[1] == w:
        return img
    lib = _c_path(img)
    if lib is None:
        return resize_bilinear_plain(img, size_wh)
    src = np.ascontiguousarray(img)
    dst = np.empty((h, w, src.shape[2]), np.uint8)
    lib.resize_bilinear_u8(_as_u8p(src), src.shape[0], src.shape[1],
                           src.shape[2], _as_u8p(dst), h, w)
    return dst


def _geometry(shape, new_hw, scaleup: bool):
    """(ratio, unpadded (w, h), (dw, dh), top, left) of a letterbox."""
    sh, sw = shape[:2]
    nh, nw = new_hw
    r = min(nh / sh, nw / sw)
    if not scaleup:
        r = min(r, 1.0)
    uw, uh = int(round(sw * r)), int(round(sh * r))
    dw, dh = (nw - uw) / 2, (nh - uh) / 2
    return r, (uw, uh), (dw, dh), int(round(dh - 0.1)), int(round(dw - 0.1))


def letterbox_plain(img: np.ndarray, new_hw: Tuple[int, int], fill: int = 114,
                    scaleup: bool = True):
    """The numpy letterbox: resize keeping the aspect ratio, then pad to
    new_hw with ``fill``. Returns (image uint8, (ratio, ratio), (dw, dh))."""
    r, (uw, uh), dwdh, top, left = _geometry(img.shape, new_hw, scaleup)
    resized = resize_bilinear_plain(img, (uw, uh))
    dst = np.full(tuple(new_hw) + img.shape[2:], fill, dtype=np.uint8)
    dst[top:top + uh, left:left + uw] = resized
    return dst, (r, r), dwdh


def letterbox(img: np.ndarray, new_hw: Tuple[int, int], fill: int = 114,
              scaleup: bool = True):
    """Resize keeping the aspect ratio, then pad to new_hw with ``fill``,
    both in the C library for (h, w, c) uint8 images. Returns (image
    uint8, (ratio, ratio), (dw, dh))."""
    lib = _c_path(img)
    if lib is None:
        return letterbox_plain(img, new_hw, fill, scaleup)
    r, (uw, uh), dwdh, top, left = _geometry(img.shape, new_hw, scaleup)
    resized = np.ascontiguousarray(resize_bilinear(img, (uw, uh)))
    nh, nw = new_hw
    dst = np.empty((nh, nw, img.shape[2]), np.uint8)
    lib.letterbox_u8(_as_u8p(resized), uh, uw, img.shape[2], _as_u8p(dst),
                     nh, nw, top, left, fill)
    return dst, (r, r), dwdh


# -- decode -------------------------------------------------------------------

def _jpeg_buffer(data) -> Optional[np.ndarray]:
    """uint8 view of JPEG bytes (or of a file's), or None when they do not
    start with the JPEG SOI marker."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        buf = np.frombuffer(data, np.uint8)
    else:
        try:
            buf = np.fromfile(data, np.uint8)
        except OSError:
            return None
    if buf.size < 3 or buf[0] != 0xFF or buf[1] != 0xD8:
        return None
    return buf


def _dims(lib, buf: np.ndarray) -> Optional[Tuple[int, int]]:
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.jpeg_dims(_as_u8p(buf), buf.size, ctypes.byref(h),
                     ctypes.byref(w)):
        return None
    return h.value, w.value


def jpeg_dims(data) -> Optional[Tuple[int, int]]:
    """(h, w) from a JPEG's header (bytes or a path), without decoding
    the pixels; None where the headers up to the first scan do not parse
    (where libjpeg's jpeg_read_header fails), or the library is not
    built."""
    if not jpeg_available():
        return None
    buf = _jpeg_buffer(data)
    return None if buf is None else _dims(_lib, buf)


def decode_jpeg(data) -> Optional[np.ndarray]:
    """A JPEG (bytes or a path) decoded by the port's decoder
    (csrc/jpeg_decode.cc) to (h, w, 3) RGB uint8, the pixels libjpeg's
    default decode gives; grayscale, progressive, arithmetic-coded and
    restart-marked files included, and a file cut short (a Huffman one
    with its missing blocks mid-grey). None when the decoder refuses it
    (not a JPEG, CMYK, lossless, 12-bit) or the library is not built."""
    if not jpeg_available():
        return None
    buf = _jpeg_buffer(data)
    if buf is None:
        return None
    hw = _dims(_lib, buf)
    if hw is None:
        return None
    out = np.empty((*hw, 3), np.uint8)
    if _lib.decode_jpeg_u8(_as_u8p(buf), buf.size, _as_u8p(out), *hw):
        return None
    return out


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_READ = 65536     # the most Pillow's loader reads of the stream at once


def _png_buffer(data) -> Optional[np.ndarray]:
    """uint8 view of PNG bytes (or of a file's), or None when they do not
    start with the PNG signature."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        buf = np.frombuffer(data, np.uint8)
    else:
        try:
            buf = np.fromfile(data, np.uint8)
        except OSError:
            return None
    if buf.size < 8 or buf[:8].tobytes() != _PNG_SIGNATURE:
        return None
    return buf


def png_dims(data) -> Optional[Tuple[int, int]]:
    """(h, w) from a PNG's header (bytes or a path), without inflating the
    pixels; None where the chunks before the first IDAT do not read (where
    Pillow's open fails), or the library is not built."""
    if not native_available():
        return None
    buf = _png_buffer(data)
    if buf is None:
        return None
    h, w = ctypes.c_int(), ctypes.c_int()
    if _lib.png_dims(_as_u8p(buf), buf.size, ctypes.byref(h),
                     ctypes.byref(w)):
        return None
    return h.value, w.value


def decode_png(data) -> Optional[np.ndarray]:
    """A PNG (bytes or a path) decoded by the port's decoder
    (csrc/png_decode.cc, inflated by zlib) to (h, w, 3) RGB uint8, the
    pixels of Pillow's ``convert("RGB")``: every colour type and bit depth,
    interlaced or not. None where Pillow fails too (a broken header chunk or
    CRC before the image data, a cut or corrupt image stream, an unknown
    filter type), or the library is not built."""
    if not native_available():
        return None
    buf = _png_buffer(data)
    if buf is None:
        return None
    info = np.zeros(6, np.int32)
    palette = np.zeros(768, np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    pos = _lib.png_header(_as_u8p(buf), buf.size, info.ctypes.data_as(i32p),
                          _as_u8p(palette))
    if pos < 0:
        return None
    spans = np.empty((max(buf.size - pos, 0) // 12 + 1, 3), np.int64)
    count = _lib.png_idat(_as_u8p(buf), buf.size, pos,
                          spans.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    need = _lib.png_raw_size(info.ctypes.data_as(i32p))
    # inflate as Pillow's loader feeds its decoder: each chunk's data in
    # reads of 64 KiB at most, until the image is whole (data past that
    # point is not inflated, so an error or a checksum there goes unseen)
    stream, view, parts, got = zlib.decompressobj(), memoryview(buf), [], 0
    off = length = 0
    for off, have, length in spans[:count].tolist():
        for start in range(off, off + have, _PNG_READ):
            piece = view[start:min(start + _PNG_READ, off + have)]
            try:
                part = stream.decompress(piece, need - got)
            except zlib.error:
                return None
            parts.append(part)
            got += len(part)
            if got == need:
                break
        if got == need:
            break
    if got < need or _lib.png_tail(_as_u8p(buf), buf.size, off + length + 4):
        return None
    raw = np.frombuffer(bytearray().join(parts), np.uint8)
    out = np.empty((int(info[0]), int(info[1]), 3), np.uint8)
    if _lib.png_to_rgb(_as_u8p(raw), info.ctypes.data_as(i32p),
                       _as_u8p(palette), _as_u8p(out)):
        return None
    return out


# -- Pillow's routes: JPEG over libjpeg-turbo 3.1.3, BMP, GIF, WebP ----------

# Pillow's JpegImagePlugin.MARKER: the codes its header walk knows, by
# what it does with their segment
_SOF = {0xFFC0, 0xFFC1, 0xFFC2, 0xFFC3, 0xFFC5, 0xFFC6, 0xFFC7, 0xFFC9,
        0xFFCA, 0xFFCB, 0xFFCD, 0xFFCE, 0xFFCF, 0xFFDE}
_SKIP = {0xFFC4, 0xFFCC, 0xFFDA, 0xFFDC, 0xFFDD, 0xFFDF}
_BARE = {0xFFC8, *range(0xFFD0, 0xFFDA), *range(0xFFF0, 0xFFFE)}
_MAX_PIXELS = pnm.MAX_PIXELS     # twice PIL.Image.MAX_IMAGE_PIXELS


def _app_fails(marker: int, seg: bytes) -> bool:
    """Where Pillow's APP handler raises on a segment (a JFIF or Adobe
    segment too short for its version field, a Photoshop resource cut
    before its name)."""
    if marker in (0xFFE0, 0xFFEE) and seg.startswith(
            b"JFIF" if marker == 0xFFE0 else b"Adobe"):
        return len(seg) < 7
    if marker == 0xFFED and seg.startswith(b"Photoshop 3.0\x00"):
        off = 14
        while seg[off:off + 4] == b"8BIM":     # struct.error ends the walk
            off += 4
            if off + 2 > len(seg):
                return False
            code = int.from_bytes(seg[off:off + 2], "big")
            off += 2
            if off >= len(seg):
                return True                    # s[offset]: IndexError
            off += 1 + seg[off]
            off += off & 1
            if off + 4 > len(seg):
                return False
            size = int.from_bytes(seg[off:off + 4], "big")
            off += 4
            if code == 0x03ED and len(seg[off:off + size]) < 14:
                return False                   # ResolutionInfo cut short
            off += size
            off += off & 1
    return False


def pillow_jpeg_size(data) -> Optional[Tuple[int, int]]:
    """(h, w) of a JPEG (bytes) as Pillow 12.1.0's open reads its header
    (JpegImageFile._open, a walk of the markers up to the first SOS), or
    None where that open fails: no FF D8 FF start, a marker it does not
    know, a segment cut short, a frame of other than 8 bits or of other
    than 1, 3 or 4 components, no frame before the scan, a size of 0."""
    data = memoryview(data).cast("B")
    n = len(data)
    if bytes(data[:3]) != b"\xff\xd8\xff":
        return None
    pos, s, size, icc = 3, 0xFF, None, []
    while True:
        if s != 0xFF:                          # junk before a marker
            if pos >= n:
                return None
            s, pos = data[pos], pos + 1
            continue
        if pos >= n:
            return None
        i, pos = 0xFF00 | data[pos], pos + 1
        if i in _SOF or i in _SKIP or i == 0xFFDB or i >= 0xFFE0 and \
                i != 0xFFFF and i not in _BARE:
            if pos + 2 > n:
                return None
            length = int.from_bytes(data[pos:pos + 2], "big") - 2
            pos += 2
            if length > 0 and pos + length > n:
                return None                    # Truncated File Read
            seg = bytes(data[pos:pos + max(length, 0)])
            pos += max(length, 0)
            if i in _SOF:
                if len(seg) < 6 or seg[0] != 8 or seg[5] not in (1, 3, 4):
                    return None
                if icc and len(sorted(icc)[0]) < 14:
                    return None
                icc = []
                if (len(seg) - 6) % 3:
                    return None                # a component cut short
                size = int.from_bytes(seg[1:3], "big"), \
                    int.from_bytes(seg[3:5], "big")
            elif i == 0xFFDB:
                while seg:
                    q = 1 + (1 if seg[0] < 16 else 2) * 64
                    if len(seg) < q:
                        return None
                    seg = seg[q:]
            elif 0xFFE0 <= i <= 0xFFEF:
                if _app_fails(i, seg):
                    return None
                if i == 0xFFE2 and seg.startswith(b"ICC_PROFILE\x00"):
                    icc.append(seg)
            if i == 0xFFDA:
                break
            if pos >= n:
                return None
            s, pos = data[pos], pos + 1
        elif i in _BARE:
            if pos >= n:
                return None
            s, pos = data[pos], pos + 1
        elif i == 0xFFFF:
            s = 0xFF
        elif i == 0xFF00:
            if pos >= n:
                return None
            s, pos = data[pos], pos + 1
        else:
            return None                        # no marker found
    if size is None or 0 in size or size[0] * size[1] > _MAX_PIXELS:
        return None
    return size


def _header_dims(dims, buf: np.ndarray, *mode) -> Optional[Tuple[int, int]]:
    h, w = ctypes.c_int(), ctypes.c_int()
    if dims(_as_u8p(buf), buf.size, ctypes.byref(h), ctypes.byref(w), *mode):
        return None
    return h.value, w.value


def _decode(dims, decode, buf: np.ndarray, *mode) -> Optional[np.ndarray]:
    hw = _header_dims(dims, buf, *mode)
    if hw is None:
        return None
    out = np.empty((*hw, 3), np.uint8)
    if decode(_as_u8p(buf), buf.size, _as_u8p(out), *hw, *mode):
        return None
    return out


def _bytes(data) -> np.ndarray:
    """uint8 view of bytes, or of a file's."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, np.uint8)
    return np.fromfile(data, np.uint8)


def decode_jpeg_pillow(data) -> Optional[np.ndarray]:
    """A JPEG (bytes or a path) as Pillow 12.1.0's ``Image.open(...)
    .convert("RGB")`` gives it over the libjpeg-turbo 3.1.3 it bundles:
    the port's decoder in its second mode (csrc/jpeg_decode.cc) behind
    Pillow's header walk. CMYK and YCCK files (Pillow's CMYK -> RGB) and
    8-bit lossless ones decode; a file cut before its image is whole gives
    None, as Pillow refuses it."""
    buf = _bytes(data)
    if pillow_jpeg_size(buf) is None:
        return None
    lib = decode_lib()
    return _decode(lib.jpeg_dims_mode, lib.decode_jpeg_u8_mode, buf, 1)


def decode_bmp(data) -> Optional[np.ndarray]:
    """A BMP (bytes or a path) as Pillow 12.1.0's ``Image.open(...)
    .convert("RGB")`` gives it (csrc/bmp_decode.cc), or None where Pillow
    fails."""
    lib = decode_lib()
    return _decode(lib.bmp_dims, lib.decode_bmp_u8, _bytes(data))


def decode_gif(data) -> Optional[np.ndarray]:
    """A GIF's first frame (bytes or a path) as Pillow 12.1.0's
    ``Image.open(...).convert("RGB")`` gives it (csrc/gif_decode.cc), or
    None where Pillow fails."""
    lib = decode_lib()
    return _decode(lib.gif_dims, lib.decode_gif_u8, _bytes(data))


def decode_webp(data) -> Optional[np.ndarray]:
    """A WebP's first frame (bytes or a path) as Pillow 12.1.0's
    ``Image.open(...).convert("RGB")`` gives it over libwebp 1.6.0
    (csrc/webp_decode.cc): lossy with its fancy upsampling, lossless, alpha
    (decoded, then dropped), an animation's first frame on its zeroed
    canvas; None where Pillow's open or load fails (a file cut short, a
    chunk or stream libwebp refuses, a canvas past the bomb limit)."""
    lib = decode_lib()
    return _decode(lib.webp_dims, lib.decode_webp_u8, _bytes(data))


def webp_size(data) -> Optional[Tuple[int, int]]:
    """(h, w) of a WebP's canvas (bytes or a path) as Pillow's open reads
    it, which demuxes the whole file; None where that open fails."""
    return _header_dims(decode_lib().webp_dims, _bytes(data))


def decode_ppm(data: bytes) -> Optional[np.ndarray]:
    """A PNM file's bytes (P1-P6, ``Pf``, Pillow's extensions) -> (h, w, 3)
    uint8 as Pillow reads them (data/pnm.py; a P6 at maxval 255 is a view
    of the bytes), or None where Pillow refuses them or takes them for
    another format."""
    try:
        return pnm.decode(data)
    except (pnm.NotPnm, ValueError):
        return None


def encode_ppm(img: np.ndarray) -> bytes:
    """(h, w, 3) uint8 -> binary PPM (P6) bytes."""
    h, w = img.shape[:2]
    return b"P6\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(
        img, np.uint8).tobytes()


def _decode_picked(data, picked: Optional[formats.Picked],
                   by_path: bool) -> Optional[np.ndarray]:
    """A file as the plugin Pillow picked reads it: None where no plugin
    takes it or the plugin's open or load fails; PIL's decode for a plugin
    the port leaves to PIL, and for a TIFF or JPEG 2000 whose tags or
    markers name what data/tiff.py or data/jpeg2k.py leave to others (the
    header alone decides, never a failed decode)."""
    if picked is None or picked.refused:
        return None
    fmt = formats.SIGNATURE_FORMATS.get(picked.name)
    if fmt is None and picked.opened is None:
        return _decode_other(data)
    if fmt == "tiff" and tiff.route(picked.opened, data) is None or \
            fmt == "jpeg2k" and jpeg2k.route(picked.opened, data) is None:
        return _decode_other(data)
    try:
        if fmt is None:
            return raster.decode(data, picked.opened, by_path)
        if fmt == "pnm":
            return pnm.decode(data, picked.opened)
        if fmt == "tiff":
            return tiff.decode(data, by_path, picked.opened)
        if fmt == "jpeg2k":
            return jpeg2k.decode(data, picked.opened)
    except ValueError:
        return None
    decode_lib()                      # a library that cannot build raises
    return {"png": decode_png, "jpeg": decode_jpeg_pillow, "bmp": decode_bmp,
            "gif": decode_gif, "webp": decode_webp}[fmt](data)


def _decode_other(data) -> Optional[np.ndarray]:
    """PIL's decode where PIL is installed, else None: the formats the port
    has no decoder of (the TIFF that data/tiff.py leaves, and the long
    tail)."""
    try:
        from PIL import Image
    except ImportError:
        return None
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))
    except Exception:  # PIL raises many types on corrupt input
        return None


def ycbcr_to_rgb(samples: np.ndarray) -> np.ndarray:
    """(h, w, 3) YCbCr uint8 -> RGB as Pillow's ``convert("RGB")`` of a
    YCbCr image gives it (its ImagingConvertYCbCr2RGB, the JPEG 2000
    decoder's j2k_ycbcr_rgb in csrc/j2k_decode.cc)."""
    h, w = samples.shape[:2]
    px = np.zeros((h, w, 4), np.uint8)
    px[..., :3] = samples
    decode_lib().j2k_ycbcr_rgb(_as_u8p(px), h * w)
    return np.ascontiguousarray(px[..., :3])


def decode_image(data: bytes,
                 by_path: bool = False) -> Optional[np.ndarray]:
    """(h, w, 3) RGB uint8 from image bytes, or None when undecodable, as
    the JAX package's server and loader decode them: a JPEG through the
    port's decoder as libjpeg-turbo 2.1 decodes it, and where that refuses
    it as Pillow does (decode_jpeg_pillow); every other file as the plugin
    Pillow's ``Image.open`` picks reads it (data/formats.py walks Pillow's
    plugins in its order): PNG, BMP, GIF, WebP, PNM (P1-P6 at every maxval,
    ``Pf``, Pillow's extensions), TIFF (uncompressed, LZW, deflate,
    PackBits, JPEG at 8 and 12 bits, old-style JPEG, ZSTD and LZMA, CCITT
    fax, ThunderScan, YCbCr and CIELab among it; data/tiff.py), JPEG 2000
    (J2K and JP2; data/jpeg2k.py), DIB, ICO, CUR, PCX, DCX, MSP, QOI, SGI,
    SPIDER, TGA, XBM and IM (data/raster.py) as Pillow decodes them; a
    file that a plugin the port does not read takes (the long tail, and
    the JPEG 2000 files whose markers name HTJ2K or Part 2's MCT) through
    PIL where it is installed; a file no plugin takes is refused. The
    format is read from the bytes, never from a name. by_path: the bytes
    are a file Pillow opens by its path (it memory-maps an uncompressed
    single-strip TIFF)."""
    if bytes(data[:2]) == b"\xff\xd8":
        decode_lib()
        img = decode_jpeg(data)
        if img is not None:
            return img
    return _decode_picked(data, formats.pick(data, by_path=by_path), by_path)


READ_NATIVELY = ("JPEG, PNG, BMP, GIF, WebP, PNM, TIFF, JPEG 2000, DIB, ICO, "
                 "CUR, PCX, DCX, MSP, QOI, SGI, SPIDER, TGA, XBM and IM")


def _loaded(path: str, img: Optional[np.ndarray]) -> np.ndarray:
    if img is None:
        raise ValueError(f"{path}: cannot decode ({READ_NATIVELY} are read "
                         "with the port's decoders, as Pillow reads them; "
                         "other formats need PIL)")
    return img


def load_image_rgb(path: str) -> np.ndarray:
    """(h, w, 3) RGB uint8 from an image file, as decode_image decodes its
    bytes (the JAX package's load_image_rgb, which opens the path). A file
    that cannot be decoded raises ValueError naming it."""
    with open(path, "rb") as f:
        return _loaded(path, decode_image(f.read(), by_path=True))


def load_image_pillow(path: str) -> np.ndarray:
    """(h, w, 3) RGB uint8 from an image file as Pillow 12.1.0's
    ``Image.open(path).convert("RGB")`` gives it, which the JAX package's
    detect ``--img`` reads: a JPEG always as Pillow's libjpeg-turbo 3.1.3
    decodes it (decode_jpeg_pillow), every other file as the plugin
    ``Image.open`` picks reads it: PNG, BMP, GIF, WebP, PNM, TIFF (every
    compression Pillow's open knows: uncompressed, LZW, deflate, PackBits,
    JPEG at 8 and 12 bits, old-style JPEG, ZSTD with its legacy frames,
    LZMA, CCITT fax, ThunderScan; YCbCr and CIELab among it; SGILog
    refused as Pillow refuses it), JPEG 2000 (J2K and JP2), DIB, ICO, CUR,
    PCX, DCX, MSP, QOI, SGI, SPIDER, TGA, XBM and IM as Pillow does, other
    formats through PIL where it is installed. A file that cannot be
    decoded raises ValueError naming it."""
    with open(path, "rb") as f:
        data = f.read()
    return _loaded(path, _decode_picked(
        data, formats.pick(data, by_path=True), True))


# a PNM header with a comment or two, and a JPEG's header segments in most
# files, fit well inside this many bytes
_HEADER_BYTES = 65536


def _header_size(fmt: str, data,
                 complete: bool) -> Optional[Tuple[int, int]]:
    """(h, w) from a file of a format the port decodes (its bytes, or a
    prefix of them where not complete), as Pillow's open reads it, or None
    where that open fails, the plugin passes the file on or the prefix is
    too short."""
    try:
        if fmt == "pnm":         # a PNM token may run on past the prefix
            return pnm.size(data, complete)
        if fmt == "jpeg2k":      # the open reads SIZ or the JP2 header
            return jpeg2k.size(data)
    except (pnm.NotPnm, jpeg2k.NotJpeg2k, ValueError):
        return None
    lib = decode_lib()
    return {"png": png_dims, "jpeg": pillow_jpeg_size,
            "bmp": lambda d: _header_dims(lib.bmp_dims, _bytes(d)),
            "gif": lambda d: _header_dims(lib.gif_dims, _bytes(d)),
            "webp": webp_size}[fmt](data)


def _picked_size(path: str, data: bytes) -> Tuple[int, int]:
    """(h, w) of a whole file as the plugin Pillow picks opens it."""
    picked = formats.pick(data, by_path=True)
    if picked is None or picked.refused:
        raise ValueError(f"{path}: cannot read the image size")
    fmt = formats.SIGNATURE_FORMATS.get(picked.name)
    if picked.opened is not None:
        size = picked.opened.size
        if isinstance(size, tuple) and len(size) == 2:
            return size[1], size[0]
    elif fmt is not None:
        hw = _header_size(fmt, data, True)
        if hw is not None:
            return tuple(hw)
    else:
        return _pil_size(path)
    raise ValueError(f"{path}: cannot read the image size")


def _pil_size(path: str) -> Tuple[int, int]:
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        try:
            with Image.open(path) as im:
                w, h = im.size
            return h, w
        except Exception:  # PIL raises many types on corrupt input
            pass
    raise ValueError(f"{path}: cannot read the image size ({READ_NATIVELY} "
                     "are read natively; other formats need PIL)")


def read_image_size(path: str) -> Tuple[int, int]:
    """(h, w) of an image file without decoding its pixels, as Pillow's
    open reads it (the JAX package's size): from the header for PNM, JPEG,
    PNG, BMP and GIF, from the whole file for WebP (whose open demuxes it
    all, so a cut file has no size), from IFD0 for TIFF (every TIFF, read
    where it lies in the file; Orientation 5-8 swaps the sides), from SIZ
    or the JP2 header for JPEG 2000, from the raster plugins' opens
    (data/raster.py: ICO's largest entry, loaded as Pillow's open loads
    it; DCX's first frame; IM's "Image size"), through PIL for the plugins
    the port leaves to it where it is installed. A file that cannot be
    read raises ValueError naming it."""
    with open(path, "rb") as f:
        data = f.read(_HEADER_BYTES)
        if len(data) == _HEADER_BYTES:
            # a long file: Pillow's plugins before each signature plugin
            # never take its files, so the prefix picks them, and the size
            # is in the header
            picked = formats.pick(data, by_path=True, prefix=True)
            fmt = picked and formats.SIGNATURE_FORMATS.get(picked.name)
            if fmt == "tiff":      # IFD0, wherever the writer put it
                try:
                    return tiff.size(tiff.FileView(f))
                except tiff.NotTiff:       # Pillow's next plugins: below
                    pass
                except ValueError:
                    raise ValueError(f"{path}: cannot read the TIFF "
                                     "header") from None
            elif fmt is not None:
                # a WebP's prefix is always refused (its RIFF size runs
                # past it): the whole file, below
                hw = _header_size(fmt, data, False)
                if hw is not None:
                    return tuple(hw)
            f.seek(0)
            data = f.read()
    return _picked_size(path, data)
