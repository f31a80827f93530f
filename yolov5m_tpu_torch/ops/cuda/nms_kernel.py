"""Hand-written CUDA NMS kernel for Hopper, bound with ctypes.

Replaces the Pallas TPU kernel ``yolov5m_tpu/ops/pallas/nms_kernel.py``
(``_nms_kernel``, entered through ``greedy_suppress_pallas``): the greedy
class-aware keep mask over K score-sorted candidates per image,
bit-identical to the sequential greedy scan.

Source: ``yolov5m_tpu_torch/csrc/nms.cu``, one kernel
(``greedy_keep_kernel``) launched once per call by ``greedy_keep_cuda``:
one thread block per image stages the image's boxes and classes in shared
memory, computes the 32x32 diagonal tiles of the suppress matrix S, then
sweeps the tiles in score order, resolving each tile's kept rows with bit
operations and ORing only the kept rows' IoU ballots into the later
"removed" words that still hold a live row. S never goes to global memory.
What bounds it: the bytes the function needs (valid and keep for every
row, box and class only for valid rows) and its IoU decisions (one per
pair of kept rows, one per removed valid row) are far below the card's
rates at the shapes used, so it is bound by latency: the launch, staging,
and a serial chain of at most ceil(K/32) tile steps, each of which costs
one word test when the tile has no live row.

On CPU tensors ``greedy_keep_cuda`` runs the plain version the kernel is
held against on the card, ``ops.nms._greedy_suppress_fixpoint``; on CUDA
tensors it launches the kernel or raises. ``greedy_keep_tiled_plain``
below follows the kernel's order step for step in plain PyTorch, so the
CPU tests check the kernel's algorithm; nothing else calls it.

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

from yolov5m_tpu_torch.ops.boxes import pairwise_iou_xyxy

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_PKG_DIR, "csrc", "nms.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "yolov5m_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")
MAX_K = 2048           # kMaxK in nms.cu: the image's rows fit shared memory
MAX_BS = 2 ** 31 - 1   # one block per image: the grid's x limit

# Launches of the kernel, counted by its wrapper where it launches it. A
# plain integer: chip_smoke.py zeroes it before a run and reads it after.
keep_launches = 0

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
        lib.nms_greedy_keep.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        lib.nms_greedy_keep.restype = ctypes.c_int
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


def _on_card(t: torch.Tensor) -> bool:
    """False for CPU tensors (the plain version runs), True for CUDA ones
    (the kernel runs); any other device is refused."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no NMS kernel for device {t.device}")
    return t.device.type == "cuda"


def _words(mask: torch.Tensor) -> list:
    """A (K,) bool mask as ceil(K/32) ints: bit j % 32 of word j // 32."""
    flags = mask.tolist()
    return [sum(1 << c for c, f in enumerate(flags[s:s + 32]) if f)
            for s in range(0, len(flags), 32)]


def _bits(word: int) -> list:
    """The set bits of a word, lowest first (the kernel's __ffs order)."""
    return [c for c in range(32) if word >> c & 1]


def _ballots(boxes, cls, rows, cols, iou_threshold) -> list:
    """One word per row: bit c set where row rows[n] suppresses row
    cols[n'] with cols[n'] % 32 == c (cols lie in one 32-row tile)."""
    sup = (pairwise_iou_xyxy(boxes[rows], boxes[cols]) > iou_threshold) \
        & (cls[rows][:, None] == cls[cols][None, :])
    return [sum(1 << (j % 32) for j, s in zip(cols, flags) if s)
            for flags in sup.tolist()]


def greedy_keep_tiled_plain(boxes: torch.Tensor, classes: torch.Tensor,
                            valid: torch.Tensor,
                            iou_threshold: float) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch, step for step, one image at
    a time: diagonal tiles, per-tile resolution of the kept rows with bit
    operations, then the kept rows' ORs into later live words only.

    Args and result as ``greedy_keep_cuda``."""
    bs, k = valid.shape
    keep = torch.zeros_like(valid)
    for b in range(bs):
        bx, cl = boxes[b], classes[b]
        valid_w = _words(valid[b])
        words = len(valid_w)
        removed = [0] * words
        kept_w = [0] * words
        diag = {}
        for t in range(words):                      # diagonal tiles
            tile = list(range(32 * t, min(32 * t + 32, k)))
            rows = [32 * t + r for r in _bits(valid_w[t])]
            if rows:
                for i, d in zip(rows, _ballots(bx, cl, rows, tile,
                                               iou_threshold)):
                    diag[i] = d & ~((2 << (i % 32)) - 1)    # columns > i
        for t in range(words):                      # the sweep
            live = valid_w[t] & ~removed[t]
            if not live:
                continue
            kept, rest = 0, live
            while rest:
                r = (rest & -rest).bit_length() - 1
                kept |= 1 << r
                rest &= rest - 1
                rest &= ~diag[32 * t + r]
            kept_w[t] = kept
            rows = [32 * t + r for r in _bits(kept)]
            for w in range(t + 1, words):
                cols = valid_w[w] & ~removed[w]
                if cols:
                    live_rows = [32 * w + c for c in _bits(cols)]
                    for hit in _ballots(bx, cl, rows, live_rows,
                                        iou_threshold):
                        removed[w] |= hit
        keep[b] = torch.tensor([bool(kept_w[j // 32] >> (j % 32) & 1)
                                for j in range(k)], dtype=torch.bool)
    return keep


def greedy_keep_cuda(boxes: torch.Tensor, classes: torch.Tensor,
                     valid: torch.Tensor,
                     iou_threshold: float) -> torch.Tensor:
    """Greedy class-aware NMS keep mask, one kernel launch per call.

    Args:
      boxes: (bs, K, 4) float32 xyxy, descending-score order.
      classes: (bs, K) float32 class ids.
      valid: (bs, K) bool, any mask (not only a prefix).
    Returns:
      (bs, K) bool keep mask, identical to ``ops.nms`` plain backends.
    """
    global keep_launches
    if boxes.dim() != 3:
        raise ValueError(f"boxes must be (bs, K, 4), got {tuple(boxes.shape)}")
    bs, k = boxes.shape[:2]
    if k > MAX_K:
        raise ValueError(f"K={k} exceeds the kernel's cap MAX_K={MAX_K}")
    if bs > MAX_BS:
        raise ValueError(f"bs={bs} exceeds the kernel's grid cap {MAX_BS}")
    _check("boxes", boxes, (bs, k, 4), torch.float32, boxes.device)
    _check("classes", classes, (bs, k), torch.float32, boxes.device)
    _check("valid", valid, (bs, k), torch.bool, boxes.device)
    if not _on_card(boxes):
        from yolov5m_tpu_torch.ops import nms    # ops.nms imports this module
        return nms.suppress(boxes, classes, valid, iou_threshold,
                            backend="torch")
    keep = torch.empty((bs, k), dtype=torch.bool, device=boxes.device)
    if bs == 0 or k == 0:
        return keep
    lib = build()
    with torch.cuda.device(boxes.device):
        err = lib.nms_greedy_keep(
            boxes.data_ptr(), classes.data_ptr(), valid.data_ptr(),
            keep.data_ptr(), bs, k, float(iou_threshold),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"nms_greedy_keep launch failed: CUDA error {err}")
    keep_launches += 1
    return keep
