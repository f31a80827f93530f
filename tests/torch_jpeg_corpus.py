"""The JPEG corpus of the port's decoder (tests/fixtures/torch_jpeg_corpus/).

Small files made from numpy seeds with PIL, cv2 and libjpeg (through the
writer tests/torch_jpeg_writer.c), one for each case the port's decoder
(yolov5m_tpu_torch/csrc/jpeg_decode.cc) must take as libjpeg takes it:
4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1 sampling, grayscale, progressive and
optimized-Huffman files, restart intervals 1 and 3, qualities 5, 50, 90
and 100 (among them a high-contrast checkerboard at 100 whose IDCT sums
leave the sample range), sizes from 1x1 to 300x1 and one 640x480, an
Adobe RGB file without JFIF, component ids alone telling YCbCr and RGB,
the standard Huffman tables left out, 16-bit quantization tables, data
after EOI, two baseline files cut mid-scan (one with restart markers)
whose padded blocks leave the range libjpeg's C range limit covers,
progressive files cut in a DC, an AC and a refinement scan (libjpeg
smooths them), arithmetic coding (4:2:0, 4:4:4, grayscale, restart
interval 3, DAC conditioning, progressive, cut mid-scan), the 640x480
scene recoded losslessly with arithmetic coding (its twins decode to its
pixels) and with AC bands never refined (a complete file libjpeg
smooths), and three files libjpeg refuses: CMYK, a file cut inside its
header and junk after SOI.

``digests.json`` holds, for each file, the sha256 of the JAX package's
decode (``yolov5m_tpu.data.native.decode_jpeg``, libjpeg-turbo) of its
bytes and the (h, w) of the header libjpeg reads, each null where it
gives None. ``chip_smoke.py`` holds the port's decoder to those digests on
a machine without libjpeg. Remake the corpus (PIL, cv2, the JAX
package's native library, and g++ with libjpeg for the writer, needed)
with

  python -m tests.torch_jpeg_corpus [folder]

File names give the width before the height.
"""

import ctypes
import functools
import hashlib
import io
import json
import os
import subprocess
import sys

import numpy as np

FOLDER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                      "torch_jpeg_corpus")
DIGESTS = "digests.json"

# cv2's sampling factors (luma h, v; chroma 1x1)
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111,
            "440": 0x121111, "411": 0x411111}

WRITER_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "torch_jpeg_writer.c")
WRITER_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "tests")


def picture(seed: int, h: int, w: int, channels: int = 3) -> np.ndarray:
    """(h, w, channels) uint8: gradients, rectangles and mild noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, channels), np.float32)
    for c in range(channels):
        f = rng.uniform(0.02, 0.2, 2)
        img[..., c] = 128 + 80 * np.sin(xx * f[0] + yy * f[1] + c)
    for _ in range(3):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        img[y0:y0 + max(1, h // 3), x0:x0 + max(1, w // 3)] = \
            rng.integers(0, 256, channels)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def checkerboard(n: int, square: int) -> np.ndarray:
    """(n, n, 3) uint8: black and white squares, red and green swapped."""
    a = ((np.indices((n, n)) // square).sum(0) % 2 * 255).astype(np.uint8)
    return np.stack([a, 255 - a, np.zeros_like(a)], -1)


def pil(arr: np.ndarray, mode: str = "RGB", **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def cv2_jpeg(arr: np.ndarray, quality: int = 90, sampling: str = "420",
             progressive: bool = False, restart: int = 0) -> bytes:
    import cv2

    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    ok, buf = cv2.imencode(".jpg", arr[..., ::-1], params)
    if not ok:
        raise RuntimeError("cv2 could not encode a JPEG")
    return buf.tobytes()


@functools.cache
def _writer():
    """tests/torch_jpeg_writer.c built with g++ and -ljpeg into build/tests
    (named by a digest of the source), and loaded; once a process."""
    with open(WRITER_SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.join(WRITER_DIR, f"libjpeg_writer_{tag}.so")
    if not os.path.isfile(path):
        os.makedirs(WRITER_DIR, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-o", tmp,
                        WRITER_SOURCE, "-ljpeg"], check=True,
                       capture_output=True)
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    u8p, ip = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
    out = [ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_ulong)]
    i = ctypes.c_int
    lib.jw_encode.argtypes = [u8p, i, i, i, i, i, i, i, i, i, ip, i, ip,
                              *out]
    lib.jw_encode.restype = ctypes.c_int
    lib.jw_transcode.argtypes = [u8p, ctypes.c_ulong, i, i, i, ip, i, *out]
    lib.jw_transcode.restype = ctypes.c_int
    lib.jw_free.argtypes = [u8p]
    lib.jw_free.restype = None
    return lib


def _written(call, *args) -> bytes:
    lib = _writer()
    buf, size = ctypes.POINTER(ctypes.c_uint8)(), ctypes.c_ulong()
    if call(*args, ctypes.byref(buf), ctypes.byref(size)):
        raise RuntimeError("libjpeg could not write the JPEG")
    try:
        return ctypes.string_at(buf, size.value)
    finally:
        lib.jw_free(buf)


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _ints(values):
    if not values:
        return None
    flat = [int(v) for v in np.ravel(values)]
    return (ctypes.c_int * len(flat))(*flat)


def _script(scans) -> tuple:
    """A scan script [(component indices, Ss, Se, Ah, Al)] as the writer's
    rows of 9 ints."""
    rows = [[len(comps), *comps, *[0] * (4 - len(comps)), ss, se, ah, al]
            for comps, ss, se, ah, al in scans or ()]
    return _ints(rows), len(rows)


def encode(arr: np.ndarray, quality: int = 90, sampling: str = "420",
           progressive: bool = False, arithmetic: bool = False,
           restart: int = 0, scans=None, dac=None) -> bytes:
    """arr ((h, w, 3) RGB or (h, w) gray uint8) through libjpeg with the
    writer: luma sampling as SAMPLING (chroma 1x1), Huffman or arithmetic
    coding, a restart interval in MCUs, a scan script [(component
    indices, Ss, Se, Ah, Al)] (None: one sequential scan, or
    jpeg_simple_progression's where progressive) and DAC conditioning (L,
    U, Kx) for every table (None: libjpeg's 0, 1, 5)."""
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w = arr.shape[:2]
    hv = SAMPLING[sampling] >> 16
    script, n = _script(scans)
    lib = _writer()
    channels = 1 if arr.ndim == 2 else arr.shape[2]
    return _written(lib.jw_encode, _u8p(arr), h, w, channels, quality,
                    hv >> 4, hv & 15, int(progressive), int(arithmetic),
                    restart, script, n, _ints(dac))


def transcode(data: bytes, progressive: bool = False,
              arithmetic: bool = False, restart: int = 0,
              scans=None) -> bytes:
    """data's DCT coefficients rewritten losslessly by libjpeg
    (jpeg_read_coefficients, jpeg_write_coefficients) with another entropy
    coding, scan script (as encode's) and restart interval."""
    buf = np.frombuffer(data, np.uint8)
    script, n = _script(scans)
    lib = _writer()
    return _written(lib.jw_transcode, _u8p(buf), len(data), int(progressive),
                    int(arithmetic), restart, script, n)


def without_marker(data: bytes, marker: int) -> bytes:
    """data with every header segment of one marker code left out."""
    out, i = bytearray(data[:2]), 2
    while i < len(data):
        code = data[i + 1]
        if code == 0xDA:                   # the first scan: keep the rest
            out += data[i:]
            break
        end = i + 2 + int.from_bytes(data[i + 2:i + 4], "big")
        if code != marker:
            out += data[i:end]
        i = end
    return bytes(out)


# every component's DC, then its AC 1-63 at Al 1, never refined: libjpeg
# smooths the complete file
UNREFINED = [((0, 1, 2), 0, 0, 0, 0), ((0,), 1, 63, 0, 1),
             ((1,), 1, 63, 0, 1), ((2,), 1, 63, 0, 1)]


def cut_in_scan(data: bytes, k: int) -> bytes:
    """data cut halfway through its k-th scan (1-based)."""
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    end = sos[k] if k < len(sos) else len(data)
    return data[:(sos[k - 1] + end) // 2]


def cases() -> dict:
    """{file name: JPEG bytes}."""
    p = picture(1, 53, 37)                 # 37x53
    out = {}
    for s in SAMPLING:
        out[f"sampling_{s}_37x53.jpg"] = cv2_jpeg(p, 90, s)
    out["gray_37x53.jpg"] = pil(p[..., 0], "L", quality=90)
    out["progressive_420_37x53.jpg"] = pil(p, quality=75, progressive=True)
    out["progressive_440_37x53.jpg"] = cv2_jpeg(p, 90, "440",
                                                progressive=True)
    out["progressive_gray_37x53.jpg"] = pil(p[..., 1], "L", quality=80,
                                            progressive=True)
    out["optimized_37x53.jpg"] = pil(p, quality=75, optimize=True)
    out["restart1_37x53.jpg"] = cv2_jpeg(p, 90, "420", restart=1)
    out["restart3_37x53.jpg"] = cv2_jpeg(p, 90, "420", restart=3)
    out["restart3_progressive_37x53.jpg"] = cv2_jpeg(
        p, 90, "420", progressive=True, restart=3)
    q = picture(2, 48, 64)
    for quality in (5, 50, 90, 100):
        out[f"quality{quality}_64x48.jpg"] = pil(q, quality=quality)
    # squares of 5: IDCT sums past the sample range at quality 100
    out["checkerboard_q100_444_40x40.jpg"] = cv2_jpeg(checkerboard(40, 5),
                                                      100, "444")
    out["checkerboard_q100_420_40x40.jpg"] = pil(checkerboard(40, 5),
                                                 quality=100)
    for w, h in ((1, 1), (2, 2), (3, 5), (7, 9), (17, 33), (1, 300),
                 (300, 1), (4, 7)):
        out[f"size_{w}x{h}.jpg"] = pil(picture(w * 1000 + h, h, w),
                                       quality=85)
    out["size_411_13x11.jpg"] = cv2_jpeg(picture(3, 11, 13), 85, "411")
    out["scene_640x480.jpg"] = pil(picture(4, 480, 640), quality=85)
    rgb = pil(picture(5, 40, 30), quality=90, keep_rgb=True)
    out["adobe_rgb_30x40.jpg"] = rgb                   # no JFIF marker
    out["ids_rgb_30x40.jpg"] = without_marker(rgb, 0xEE)
    out["ids_ycc_30x40.jpg"] = without_marker(pil(picture(6, 40, 30),
                                                  quality=90), 0xE0)
    out["standard_tables_60x50.jpg"] = without_marker(
        cv2_jpeg(picture(7, 50, 60), 75), 0xC4)
    out["dqt16_40x30.jpg"] = pil(picture(8, 30, 40),
                                 qtables=[list(range(1, 65)), [300] * 64])
    out["after_eoi_40x30.jpg"] = pil(picture(9, 30, 40), quality=80) + \
        b"not part of the image \xff\x12\x34"
    # cut mid-scan: libjpeg feeds zero bits, decodes the MCU they reach
    # from them (IDCT sums beyond +-512: its SIMD saturates where its C
    # range limit wraps) and leaves the rest mid-grey
    cut = cv2_jpeg(picture(14, 64, 96), 85, "420")
    out["cut_mid_scan_96x64.jpg"] = cut[:int(len(cut) * 0.32)]
    cut = cv2_jpeg(picture(11, 64, 96), 85, "420", restart=3)
    out["cut_mid_scan_restart3_96x64.jpg"] = cut[:int(len(cut) * 0.66)]
    # refused by libjpeg: None
    out["cmyk_30x20.jpg"] = pil(picture(12, 20, 30, 4), "CMYK", quality=80)
    out["cut_in_header.jpg"] = pil(picture(13, 20, 30))[:100]
    out["junk_after_soi.jpg"] = b"\xff\xd8" + np.random.default_rng(
        15).integers(0, 256, 300, np.uint8).tobytes()
    # progressive Huffman files cut in jpeg_simple_progression's first DC
    # scan, in its first AC scan (Y 1-5) and in a refinement (Y 1-63, Ah 2)
    cut = encode(picture(16, 64, 96), 85, "420", progressive=True)
    out["progressive_cut_dc_96x64.jpg"] = cut_in_scan(cut, 1)
    cut = encode(picture(17, 64, 96), 85, "420", progressive=True)
    out["progressive_cut_ac_96x64.jpg"] = cut_in_scan(cut, 2)
    cut = encode(picture(18, 64, 96), 85, "420", progressive=True, restart=3)
    out["progressive_cut_refine_restart3_96x64.jpg"] = cut_in_scan(cut, 6)
    # arithmetic coding (SOF9 sequential, SOF10 progressive)
    for s in ("420", "444"):
        out[f"arith_{s}_37x53.jpg"] = encode(p, 90, s, arithmetic=True)
    out["arith_gray_37x53.jpg"] = encode(p[..., 0], 90, arithmetic=True)
    out["arith_restart3_37x53.jpg"] = encode(p, 90, arithmetic=True,
                                             restart=3)
    out["arith_dac_37x53.jpg"] = encode(p, 90, arithmetic=True,
                                        dac=(2, 5, 10))
    out["arith_progressive_420_37x53.jpg"] = encode(
        p, 90, arithmetic=True, progressive=True)
    out["arith_progressive_gray_37x53.jpg"] = encode(
        p[..., 1], 90, arithmetic=True, progressive=True)
    # cut: libjpeg decodes the rest of the scan from zero bytes
    cut = encode(picture(19, 64, 96), 85, arithmetic=True)
    out["arith_cut_mid_scan_96x64.jpg"] = cut[:len(cut) // 2]
    cut = encode(picture(20, 64, 96), 85, arithmetic=True, progressive=True)
    out["arith_progressive_cut_96x64.jpg"] = cut_in_scan(cut, 5)
    # the scene's coefficients losslessly recoded: the arithmetic twins
    # decode to the scene's own pixels; the unrefined files are smoothed
    scene = out["scene_640x480.jpg"]
    out["scene_arith_640x480.jpg"] = transcode(scene, arithmetic=True)
    out["scene_arith_progressive_640x480.jpg"] = transcode(
        scene, progressive=True, arithmetic=True)
    out["scene_unrefined_640x480.jpg"] = transcode(scene, scans=UNREFINED)
    out["scene_unrefined_arith_640x480.jpg"] = transcode(
        scene, arithmetic=True, scans=UNREFINED)
    return out


def jax_dims(data: bytes):
    """(h, w) as the JAX package's libjpeg reads the header, or None."""
    from yolov5m_tpu.data import native

    lib = native._load_lib()
    buf = np.frombuffer(data, np.uint8)
    if buf.size < 3 or buf[0] != 0xFF or buf[1] != 0xD8:
        return None
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.jpeg_dims(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                     buf.size, ctypes.byref(h), ctypes.byref(w)):
        return None
    return [h.value, w.value]


def reference(data: bytes) -> dict:
    """The JAX package's decode of data: its sha256 and the header's size."""
    from yolov5m_tpu.data import native

    img = native.decode_jpeg(data)
    return {"sha256": None if img is None else digest(img),
            "hw": jax_dims(data)}


def digest(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def load(folder: str = FOLDER) -> dict:
    """{file name: {"sha256": ..., "hw": [h, w]}} of digests.json."""
    with open(os.path.join(folder, DIGESTS)) as f:
        return json.load(f)


def write(folder: str = FOLDER) -> dict:
    """Write every case and digests.json into folder; returns the digests."""
    os.makedirs(folder, exist_ok=True)
    digests = {}
    for name, data in sorted(cases().items()):
        with open(os.path.join(folder, name), "wb") as f:
            f.write(data)
        digests[name] = reference(data)
    with open(os.path.join(folder, DIGESTS), "w") as f:
        f.write("{\n" + ",\n".join(
            f" {json.dumps(k)}: {json.dumps(v, sort_keys=True)}"
            for k, v in digests.items()) + "\n}\n")
    return digests


if __name__ == "__main__":
    print(json.dumps(write(*sys.argv[1:]), indent=1, sort_keys=True))
