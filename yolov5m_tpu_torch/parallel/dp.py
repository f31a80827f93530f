"""Data-parallel training over a torch.distributed process group.

Port of ``yolov5m_tpu/parallel/dp.py``. The JAX package runs one
shard_mapped program over a 1-D "data" mesh; the port runs one process
(rank) per device, each holding a full replica of the training state:

  * each rank takes rows [r*per, (r+1)*per) of every global batch
    (``local_batch_slice``; the loaders build only those rows);
  * the loss is global: its denominators are all-reduced and each rank
    differentiates its own share (``train/loss.py``), so the shares' sum is
    the single-process loss on the global batch;
  * after every micro-batch's backward one flat all_reduce sums the
    gradients over ranks, so every rank holds the global accumulated
    gradient and applies the same update (``train/trainer.py``);
  * BatchNorm normalizes with local statistics, the JAX default, and its
    running buffers are averaged over ranks after every micro-batch;
    ``YOLOv5(bn_group=...)`` makes it sync-BN, the JAX ``bn_axis``.

The backend is an argument: "nccl" for CUDA, "gloo" for the CPU and for
several ranks that share one card (NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as dist

# rank 0 evaluates and writes checkpoints while the others wait at a
# barrier: the collective timeout must outlast an evaluation
TIMEOUT = datetime.timedelta(hours=2)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: str = "nccl") -> int:
    """Join a process group: ``coordinator_address`` ("host:port" or a
    URL) with the world size and this process's rank, or none of the three
    to read them from the environment (torchrun's MASTER_ADDR, RANK, ...).
    Returns this process's rank."""
    if coordinator_address is None:
        if num_processes is not None or process_id is not None:
            # an explicit topology without a coordinator would be silently
            # replaced by whatever the environment says
            raise ValueError(
                "num_processes/process_id require coordinator_address; pass "
                "all three, or none to read them from the environment")
        dist.init_process_group(backend, timeout=TIMEOUT)
    else:
        if num_processes is None or process_id is None:
            raise ValueError(
                "coordinator_address requires num_processes and process_id; "
                "pass all three, or none to read them from the environment")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id,
                                timeout=TIMEOUT)
    return dist.get_rank()


def free_port() -> int:
    """A TCP port on localhost that nothing listens on, for a group's
    ``tcp://127.0.0.1:<port>``."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_mesh(n_devices: Optional[int] = None,
              device: str = "cuda") -> List[torch.device]:
    """The devices of a 1-D data-parallel layout: the first ``n_devices``
    CUDA cards (all of them by default), or ``n_devices`` entries "cpu"
    (ranks on the host's cores; one by default). Never truncates: asking
    for more devices than exist raises."""
    kind = torch.device(device).type
    have = (torch.cuda.device_count() if kind == "cuda"
            else os.cpu_count() or 1)
    n = (have if kind == "cuda" else 1) if n_devices is None else n_devices
    if have < n:
        # the caller sized batches and throughput to n_devices
        raise ValueError(f"requested a {n}-device mesh but only {have} "
                         f"{kind} devices are available")
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device(kind)] * n


def local_batch_slice(global_batch_size: int, rank: Optional[int] = None,
                      world_size: Optional[int] = None) -> slice:
    """The rows of the global batch this rank feeds; rank and world size
    default to the process group's, (0, 1) without one."""
    group = dist.is_initialized()
    if rank is None:
        rank = dist.get_rank() if group else 0
    if world_size is None:
        world_size = dist.get_world_size() if group else 1
    if global_batch_size % world_size:
        # never truncate silently: flooring the per-rank share would drop
        # rows while the loss and the rates are sized to the global batch
        raise ValueError(
            f"global batch {global_batch_size} is not divisible by the "
            f"{world_size} participating ranks")
    per = global_batch_size // world_size
    return slice(rank * per, (rank + 1) * per)


@torch.no_grad()
def replicate_state(trainer, group=None, src: int = 0) -> None:
    """Broadcast the training state from rank ``src``: parameters, BN
    buffers, EMA, the optimizer's moments and counts, and the accumulated
    gradients. Afterwards every rank holds the same state bitwise. The
    ranks must hold the same kind of state (all fresh, or all loaded from
    one checkpoint)."""
    params = trainer.params
    opt = trainer.optimizer
    pg = opt.param_groups[0]
    layout = [[p.grad is not None for p in params],
              [sorted(opt.state.get(p, {})) for p in params]]
    box = [(layout, trainer.step, pg["count"], pg["notfinite"])]
    dist.broadcast_object_list(box, src=src, group=group)
    if box[0][0] != layout:
        raise ValueError("the ranks hold training states of different "
                         "layouts (gradients or optimizer moments)")
    trainer.step, pg["count"], pg["notfinite"] = box[0][1:]
    tensors = params + list(trainer.model.buffers()) + list(trainer.ema)
    tensors += [p.grad for p in params if p.grad is not None]
    tensors += [t for p in params for t in opt.state.get(p, {}).values()]
    for t in tensors:
        dist.broadcast(t, src=src, group=group)


def make_dp_train_step(model, loss_fn, optimizer, accumulate: int = 1,
                       group=None):
    """The DP trainer: a ``Trainer`` whose loss is global over ``group``
    (default: the whole world) and whose gradients and BN buffers are
    reduced over it, with its state replicated from rank 0. Build the
    model with ``bn_group`` for sync-BN."""
    from yolov5m_tpu_torch.train.trainer import Trainer

    group = dist.group.WORLD if group is None else group
    trainer = Trainer(model, loss_fn, optimizer, accumulate, group=group)
    replicate_state(trainer, group)
    return trainer
