"""Seeding, step timing, profiler traces and anomaly detection.

Port of ``yolov5m_tpu/utils/misc.py``:
  * seed_everything seeds Python's, numpy's and torch's generators (torch's
    seeds every CUDA device too) and returns a ``torch.Generator``, where
    JAX returns a PRNG key;
  * StepTimer is the JAX package's;
  * profile_trace records ``torch.profiler`` (host, and the card's
    kernels where there is one) and writes a Chrome trace, where JAX writes
    a TensorBoard trace;
  * nan_debug turns on ``torch.autograd.set_detect_anomaly``, which names
    the forward operation of a backward that produced NaN, where JAX checks
    every output for NaN.
``enable_compile_cache`` has no counterpart: it points JAX's persistent
compilation cache at a directory, and the port compiles nothing through
XLA (its one CUDA library is built once and kept in build/).
"""

from __future__ import annotations

import contextlib
import os
import random
import time
from typing import Iterator, Optional

import numpy as np
import torch

# the Chrome trace profile_trace writes in its logdir
TRACE_FILE = "trace.json"


def seed_everything(seed: int = 42) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators; return a CPU
    ``torch.Generator`` seeded with ``seed``.

    Hash randomization cannot be seeded here: the interpreter reads
    PYTHONHASHSEED once at startup."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


@contextlib.contextmanager
def profile_trace(logdir: Optional[str] = None) -> Iterator[
        Optional[torch.profiler.profile]]:
    """Record the block with ``torch.profiler`` (CPU, and CUDA where a card
    is present) and write a Chrome trace to ``logdir/TRACE_FILE``; yields
    the profiler, whose ``key_averages()`` sum the block's operations.
    Without a logdir, a timed span printed to stdout (yields None)."""
    if not logdir:
        t0 = time.perf_counter()
        try:
            yield None
        finally:
            print(f"[profile] span took {time.perf_counter() - t0:.3f}s")
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def nan_debug(enable: bool = True) -> None:
    """Turn autograd's anomaly detection on or off (slow: debugging only)."""
    torch.autograd.set_detect_anomaly(enable)


class StepTimer:
    """Per-step wall-clock timing with EMA, for train-loop observability."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.ema = dt if self.ema is None else \
            self.alpha * dt + (1 - self.alpha) * self.ema
        return dt
