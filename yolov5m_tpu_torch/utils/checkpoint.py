"""Checkpoints with the JAX package's run layout, in torch's format.

Port of ``yolov5m_tpu/utils/checkpoint.py``:
  * per-epoch files SAVED_CHECKPOINT/{model_N}/checkpoint_epoch_{e}.pt,
    each the full training state (``Trainer.state_dict()``: model with BN
    statistics, optimizer moments and count, EMA, accumulated gradients,
    micro-batch count), so a resume is exact;
  * run names model_1, model_2, ...; resume finds the highest epoch;
  * checkpoint_best.pt and best.txt follow the best mAP50;
  * every file is written to a temporary name and moved into place with
    ``os.replace``, so no reader sees a torn file.

Files are read with ``torch.load(weights_only=True)``: tensors, numbers,
strings, lists and dicts only.

``strip_checkpoint`` turns a training state into the deployment weights:
the model's state dict with the EMA as its parameters, f32 cast to bf16.
"""

from __future__ import annotations

import io
import os
import re
import threading
from typing import Any, Dict, Optional

import torch

CKPT_RE = re.compile(r"checkpoint_epoch_(\d+)\.pt$")


def _map_tensors(fn, obj: Any) -> Any:
    """A copy of a nested state (dicts, lists, tuples) with fn applied to
    every tensor."""
    if isinstance(obj, torch.Tensor):
        return fn(obj.detach())
    if isinstance(obj, dict):
        return {k: _map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(fn, v) for v in obj)
    return obj


def _serialize(state: Any) -> bytes:
    """Fetch to the host and serialize. Callers that write one state to
    several paths serialize once and reuse the bytes."""
    buf = io.BytesIO()
    torch.save(_map_tensors(torch.Tensor.cpu, state), buf)
    return buf.getvalue()


def _write_atomic(out: str, blob: bytes) -> str:
    tmp = out + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, out)
    return out


def save_checkpoint(state: Any, folder_path: str, filename: str,
                    epoch: int) -> str:
    """Write ``state`` as folder_path/filename/checkpoint_epoch_{epoch}.pt.
    Returns the path."""
    path = os.path.join(folder_path, filename)
    os.makedirs(path, exist_ok=True)
    return _write_atomic(os.path.join(path, f"checkpoint_epoch_{epoch}.pt"),
                         _serialize(state))


def load_checkpoint(folder_path: str, filename: str, epoch: int,
                    map_location="cpu") -> Any:
    """The state saved by save_checkpoint for this epoch."""
    path = os.path.join(folder_path, filename, f"checkpoint_epoch_{epoch}.pt")
    return torch.load(path, map_location=map_location, weights_only=True)


def latest_epoch(folder_path: str, filename: str) -> Optional[int]:
    """Highest epoch with a checkpoint in the run folder, None if none."""
    run_dir = os.path.join(folder_path, filename)
    if not os.path.isdir(run_dir):
        return None
    epochs = [int(m.group(1)) for f in os.listdir(run_dir)
              if (m := CKPT_RE.search(f))]
    return max(epochs) if epochs else None


def next_run_name(folder_path: str) -> str:
    """model_1 if none exist, else model_{max+1}."""
    if not os.path.isdir(folder_path):
        return "model_1"
    nums = [int(m.group(1)) for name in os.listdir(folder_path)
            if (m := re.fullmatch(r"model_(\d+)", name))]
    return f"model_{max(nums) + 1}" if nums else "model_1"


def save_best(state: Any, folder_path: str, filename: str, epoch: int,
              metric: float) -> Optional[str]:
    """Write checkpoint_best.pt (and best.txt: epoch and metric) when
    ``metric`` beats the recorded best. Returns the path, or None."""
    run_dir = os.path.join(folder_path, filename)
    os.makedirs(run_dir, exist_ok=True)
    if not _best_improves(run_dir, metric):
        return None
    return _commit_best(run_dir, _serialize(state), epoch, metric)


def _best_improves(run_dir: str, metric: float) -> bool:
    marker = os.path.join(run_dir, "best.txt")
    prev = -float("inf")
    if os.path.isfile(marker):
        try:
            with open(marker) as f:
                prev = float(f.read().split()[1])
        except (IndexError, ValueError):
            pass
    return metric > prev


def _commit_best(run_dir: str, blob: bytes, epoch: int, metric: float) -> str:
    out = _write_atomic(os.path.join(run_dir, "checkpoint_best.pt"), blob)
    marker = os.path.join(run_dir, "best.txt")
    with open(marker + ".tmp", "w") as f:
        f.write(f"{epoch} {metric:.6f}\n")
    os.replace(marker + ".tmp", marker)
    return out


class AsyncCheckpointer:
    """Write checkpoints while the next epoch trains.

    save() snapshots the state with a copy on its device (the training
    step updates parameters in place), then a background thread fetches
    it to the host, serializes it once and writes the epoch file and, when
    the metric improved, checkpoint_best. At most one write is in flight:
    the next save() and wait() join it and re-raise any error it hit.
    Call wait() after the epoch loop so the last checkpoint is on disk."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def save(self, state: Any, folder_path: str, filename: str, epoch: int,
             best_metric: Optional[float] = None) -> None:
        self.wait()
        snap = _map_tensors(torch.Tensor.clone, state)

        def job():
            try:
                run_dir = os.path.join(folder_path, filename)
                os.makedirs(run_dir, exist_ok=True)
                blob = _serialize(snap)
                _write_atomic(os.path.join(
                    run_dir, f"checkpoint_epoch_{epoch}.pt"), blob)
                if best_metric is not None and _best_improves(run_dir,
                                                              best_metric):
                    best = _commit_best(run_dir, blob, epoch, best_metric)
                    print(f"=> New best mAP50 {best_metric:.4f} -> {best}",
                          flush=True)
            except BaseException as e:   # re-raised by the next wait()
                self._err = e

        self._thread = threading.Thread(target=job, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the write in flight (if any) ends; re-raise its
        error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err


def with_ema(state: Dict[str, Any], model: torch.nn.Module) -> Dict[str,
                                                                  Any]:
    """The model state dict of a training state (``Trainer.state_dict()``)
    with its EMA in place of the parameters. The EMA is a list in
    ``model.named_parameters()`` order; raises ValueError where its length
    does not fit ``model``."""
    names = [n for n, _ in model.named_parameters()]
    if len(names) != len(state["ema"]):
        raise ValueError(f"{len(state['ema'])} EMA tensors for "
                         f"{len(names)} parameters")
    return {**state["model"], **dict(zip(names, state["ema"]))}


def strip_checkpoint(state: Any, model: torch.nn.Module,
                     keep_ema: bool = True) -> Dict[str, torch.Tensor]:
    """Deployment strip of a training state (``Trainer.state_dict()``, or
    a bare model state dict) of ``model``'s shape: the inference weights
    only, with the EMA in place of the parameters when ``keep_ema`` (and
    the state has one), f32 cast to bf16, on the host. Returns a state dict
    that detect's and export's ``--checkpoint`` load (save it with
    ``torch.save``)."""
    if "model" not in state:
        sd = state
    elif keep_ema and state.get("ema") is not None:
        sd = with_ema(state, model)
    else:
        sd = state["model"]
    return {k: (v.detach().cpu().to(torch.bfloat16)
                if v.dtype == torch.float32 else v.detach().cpu())
            for k, v in sd.items()}
