"""Hand-written CUDA NMS kernel for Hopper, bound with ctypes.

Replaces the Pallas TPU kernel ``yolov5m_tpu/ops/pallas/nms_kernel.py``
(``_nms_kernel``, entered through ``greedy_suppress_pallas``): the greedy
class-aware keep mask over K score-sorted candidates per image,
bit-identical to the sequential greedy scan.

Source: ``yolov5m_tpu_torch/csrc/nms.cu``, two kernels with one wrapper
each, launched in turn by ``greedy_suppress_cuda``:
  * ``suppress_bits_cuda`` (phase 1) packs the suppress matrix S into
    uint32 words with one warp ballot per (row, 32 columns);
  * ``greedy_sweep_cuda`` (phase 2) sweeps the rows in score order with one
    warp per image, holding the "removed" bitmask in registers.
What bounds them on the card: at serving shapes neither moves enough
bytes (phase 1 writes bs*K*K/8 of S) nor does enough work (bs*K*K/2 IoUs)
to reach the card's rates, so both are latency-bound. Phase 1 gives a
warp to every (row, word) pair, about half of them wholly below the
diagonal; phase 2 is a chain of K dependent steps per image, answered by
keeping the chain's state in registers and S in L2 (4 MB at bs=128,
K=512). On an H100 at bs=128, K=512 phase 1 takes about two thirds of the
pair (PERF.md); trimming its grid, and a fused single launch with S in
shared memory, are later work.

On CPU tensors each wrapper runs its plain version (``*_plain`` below)
instead; on CUDA tensors it launches its kernel or raises.

The library is built at first use with ``nvcc`` from the package's own
source into ``build/yolov5m_tpu_torch/`` (named after a hash of the source
and flags, written to a temp name and renamed), then loaded with ctypes.
Nothing here runs at import: the CPU tests import this module without a
toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_PKG_DIR, "csrc", "nms.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "yolov5m_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")
MAX_K = 2048   # kMaxK in nms.cu: two 32-bit "removed" words per lane

# Launches of each kernel, counted by its wrapper where it launches it.
# Plain integers: chip_smoke.py zeroes them before a run and reads them after.
bits_launches = 0
sweep_launches = 0

_lib = None
_lock = threading.Lock()
build_seconds = None   # wall time of the nvcc build, when this process built
build_log = ""         # nvcc's -Xptxas -v report (registers, spills)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA NMS kernel is built from "
                       "source at first use and needs the CUDA toolkit")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libnms_{digest.hexdigest()[:16]}.so")


def build() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; returns the CDLL."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.isfile(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                    capture_output=True, text=True, timeout=600)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            build_seconds = time.perf_counter() - t0
            build_log = proc.stdout + proc.stderr
        lib = ctypes.CDLL(path)
        lib.nms_suppress_bits.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        lib.nms_suppress_bits.restype = ctypes.c_int
        lib.nms_greedy_sweep.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.nms_greedy_sweep.restype = ctypes.c_int
        lib.nms_max_k.argtypes = []
        lib.nms_max_k.restype = ctypes.c_int
        if lib.nms_max_k() != MAX_K:
            raise RuntimeError("nms.cu kMaxK disagrees with MAX_K")
        _lib = lib
        return lib


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> None:
    """Raise unless t has this shape, dtype and device and is contiguous."""
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the rest on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_k(bs: int, k: int) -> None:
    if k > MAX_K:
        raise ValueError(f"K={k} exceeds the kernel's cap MAX_K={MAX_K}")
    if bs > 65535:
        raise ValueError(f"bs={bs} exceeds the kernel's grid cap 65535")


def _on_card(t: torch.Tensor) -> bool:
    """False for CPU tensors (the plain version runs), True for CUDA ones
    (the kernel runs); any other device is refused."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no NMS kernel for device {t.device}")
    return t.device.type == "cuda"


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def pack_rows(smat: torch.Tensor) -> torch.Tensor:
    """(bs, K, K) bool -> (bs, K, ceil(K/32)) int32: bit j % 32 of word
    j // 32 of row i is smat[:, i, j] (nms.cu's layout of S)."""
    bs, k, _ = smat.shape
    words = (k + 31) // 32
    bits = torch.zeros((bs, k, words * 32), dtype=torch.int64,
                       device=smat.device)
    bits[..., :k] = smat.long()
    weights = torch.ones(32, dtype=torch.int64, device=smat.device) << \
        torch.arange(32, device=smat.device)
    packed = (bits.view(bs, k, words, 32) * weights).sum(-1)
    return torch.where(packed >= 1 << 31, packed - (1 << 32),
                       packed).to(torch.int32)


def unpack_rows(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of pack_rows: (bs, K, words) int32 -> (bs, K, K) bool."""
    shifts = torch.arange(32, device=packed.device, dtype=torch.int32)
    bits = (packed[..., None] >> shifts) & 1
    return bits.flatten(-2)[..., :k].bool()


def suppress_bits_plain(boxes: torch.Tensor, classes: torch.Tensor,
                        iou_threshold: float) -> torch.Tensor:
    """Phase 1's plain version: the packed suppress matrix S."""
    from yolov5m_tpu_torch.ops.nms import _suppress_matrix
    return pack_rows(_suppress_matrix(boxes, classes, iou_threshold))


def greedy_sweep_plain(smat: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Phase 2's plain version: the greedy fixpoint over the unpacked S."""
    from yolov5m_tpu_torch.ops.nms import _greedy_suppress_fixpoint
    return _greedy_suppress_fixpoint(unpack_rows(smat, valid.shape[1]), valid)


def suppress_bits_cuda(boxes: torch.Tensor, classes: torch.Tensor,
                       iou_threshold: float) -> torch.Tensor:
    """Phase 1: S[i, j] = IoU(i, j) > t & cls_i == cls_j & j > i, packed.

    Args:
      boxes: (bs, K, 4) float32 xyxy, descending-score order.
      classes: (bs, K) float32 class ids.
    Returns:
      (bs, K, ceil(K/32)) int32, laid out as ``pack_rows`` says.
    """
    global bits_launches
    if boxes.dim() != 3:
        raise ValueError(f"boxes must be (bs, K, 4), got {tuple(boxes.shape)}")
    bs, k = boxes.shape[:2]
    _check_k(bs, k)
    _check("boxes", boxes, (bs, k, 4), torch.float32, boxes.device)
    _check("classes", classes, (bs, k), torch.float32, boxes.device)
    if not _on_card(boxes):
        return suppress_bits_plain(boxes, classes, iou_threshold)
    smat = torch.empty((bs, k, (k + 31) // 32), dtype=torch.int32,
                       device=boxes.device)
    if bs == 0 or k == 0:
        return smat
    lib = build()
    with torch.cuda.device(boxes.device):
        _raise_on(lib.nms_suppress_bits(
            boxes.data_ptr(), classes.data_ptr(), smat.data_ptr(), bs, k,
            float(iou_threshold), torch.cuda.current_stream().cuda_stream),
            "nms_suppress_bits")
    bits_launches += 1
    return smat


def greedy_sweep_cuda(smat: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Phase 2: the greedy keep mask from phase 1's packed S.

    Args:
      smat: (bs, K, ceil(K/32)) int32 from ``suppress_bits_cuda``.
      valid: (bs, K) bool.
    Returns:
      (bs, K) bool keep mask.
    """
    global sweep_launches
    if valid.dim() != 2:
        raise ValueError(f"valid must be (bs, K), got {tuple(valid.shape)}")
    bs, k = valid.shape
    _check_k(bs, k)
    _check("valid", valid, (bs, k), torch.bool, valid.device)
    _check("smat", smat, (bs, k, (k + 31) // 32), torch.int32, valid.device)
    if not _on_card(valid):
        return greedy_sweep_plain(smat, valid)
    keep = torch.empty((bs, k), dtype=torch.bool, device=valid.device)
    if bs == 0 or k == 0:
        return keep
    lib = build()
    with torch.cuda.device(valid.device):
        _raise_on(lib.nms_greedy_sweep(
            smat.data_ptr(), valid.data_ptr(), keep.data_ptr(), bs, k,
            torch.cuda.current_stream().cuda_stream), "nms_greedy_sweep")
    sweep_launches += 1
    return keep


def greedy_suppress_cuda(boxes: torch.Tensor, classes: torch.Tensor,
                         valid: torch.Tensor,
                         iou_threshold: float) -> torch.Tensor:
    """Greedy class-aware NMS keep mask: phase 1, then phase 2.

    Args:
      boxes: (bs, K, 4) float32 xyxy, descending-score order.
      classes: (bs, K) float32 class ids.
      valid: (bs, K) bool.
    Returns:
      (bs, K) bool keep mask, identical to ``ops.nms`` plain backends.
    """
    _check("valid", valid, tuple(boxes.shape[:2]), torch.bool, boxes.device)
    return greedy_sweep_cuda(
        suppress_bits_cuda(boxes, classes, iou_threshold), valid)
