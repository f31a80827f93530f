"""Training CLI: port of ``yolov5m_tpu/cli/train.py``.

Trains on a disk dataset (COCO/FLIR txt labels under
datasets/{data}/images|labels/{train,val}, or --datasets_dir) or on the
on-device synthetic stream (--data synth). Each epoch trains, evaluates
the EMA weights through the fused detection path (the CUDA NMS kernel on
the card, conf 0.01, K 1024), appends eval.csv, draws prediction images
unless --nosaveimgs, and writes SAVED_CHECKPOINT/{run}/checkpoint_epoch_{e}.pt
in the background. The model trains with f32 weights and bf16 activations
(explicit casts, no GradScaler), as the JAX CLI does.

Augmentation: the host loader runs mosaic (--mosaic), HSV (--hsv) and
TrainAugment, whose image ops are the port's C (data/augment.py); --device_mosaic moves mosaic and --device_augment
moves HSV, color jitter and flips onto the device (ops/augment_device.py),
one augmentation step per square batch. --rect batches are not square,
so --rect keeps the augmentation on the host.

Data parallelism (--dp N; 0, the default, means every visible card, or
one process with --device cpu): N processes, one a device (NCCL on
cuda:r, gloo on the CPU), each training on its rows of every global
batch of --bs with the global loss (parallel/dp.py). accumulate comes
from the global --bs. Rank 0 alone evaluates, writes the CSV, the
checkpoints and anchors.json, and prints; the other ranks wait at a
barrier. The device augmentation runs on each rank's rows, its seed
folded with the rank.

Usage (on a machine with a CUDA card):
  python -m yolov5m_tpu_torch.cli.train --data mydata --datasets_dir /data \\
      --bs 16 --epochs 3 --device_mosaic --mosaic 0.5 --device_augment --hsv
  python -m yolov5m_tpu_torch.cli.train --data synth \\
      --bs 16 --epochs 3 --synth_steps 50
  python -m yolov5m_tpu_torch.cli.train --data synth --dp 4 \\
      --bs 64 --epochs 3

Spatial, tensor and pipeline parallelism (--sp N, --tp N, --pp N, one of
them): one process drives a grid of devices (parallel/sp.py, tp.py,
pp.py), the master state on its first device; --dp composes as the grid's
data axis (0: for --sp and --tp every card the other axis leaves, one row
on the CPU; for --pp one row). --sp
shards the image rows (every train size divisible by N; a --rect batch
whose height is not raises at its step, as in JAX), --tp the output
channels, --pp the model's stages over --pp_micro micro-batches a step
(default N; --bs must divide by pp_micro x dp), each step then one
update. With --device cpu every grid cell is the host; on
the card a grid needs that many cards.

--flat_opt is refused with SystemExit: it only resumes JAX checkpoints.
--no_flat_opt is accepted and does nothing, as in JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

# flag -> (is it set?, why the port refuses it)
REFUSED = (
    ("flat_opt", lambda o: o.flat_opt,
     "nothing: it only resumes JAX checkpoints, which the port cannot read"),
)

# per-device load (images at 640^2 equivalent) from which remat is turned
# on by itself, the JAX CLI's rule (--no_remat opts out)
AUTO_REMAT_LOAD = 96


def arg_parser(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", type=str, default="coco",
                   help="dataset name under datasets/ (or --datasets_dir), "
                        "or 'synth' for the on-device synthetic stream")
    p.add_argument("--box_format", type=str, default="coco",
                   choices=["coco", "yolo"])
    p.add_argument("--datasets_dir", type=str, default=None,
                   help="the datasets root (default: ./datasets)")
    p.add_argument("--nw", type=int, default=4,
                   help="loader worker threads (host-side prefetch)")
    p.add_argument("--nosaveimgs", action="store_true",
                   help="skip the epoch's prediction images "
                        "(SAVED_IMAGES/{run}/EPOCH_{n}/image_{i}.png)")
    p.add_argument("--nosavemodel", action="store_true")
    p.add_argument("--nosavelogs", action="store_true")
    p.add_argument("--epochs", type=int, default=273)
    p.add_argument("--ultralytics_loss", action="store_true")
    p.add_argument("--rect", action="store_true", help="rectangular training")
    p.add_argument("--bs", type=int, default=16)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--filename", type=str, default=None)
    p.add_argument("--load_coco_weights", action="store_true",
                   help="start from a torch-layout state dict (--weights)")
    p.add_argument("--weights", type=str, default="yolov5m_coco.npz",
                   help="npz of torch-layout weights for --load_coco_weights")
    p.add_argument("--only_eval", action="store_true")
    p.add_argument("--first_out", type=int, default=None,
                   help="width override (default: from --model)")
    p.add_argument("--model", type=str, default="m",
                   choices=["n", "s", "m", "l", "x"])
    p.add_argument("--image_size", type=int, default=640)
    p.add_argument("--max_boxes", type=int, default=None,
                   help="label capacity per image (default 120; 8 for "
                        "--data synth)")
    p.add_argument("--iou_type", type=str, default="giou",
                   choices=["giou", "ciou", "diou", "iou"])
    p.add_argument("--mosaic", type=float, default=0.0,
                   help="mosaic-4 probability")
    p.add_argument("--hsv", action="store_true",
                   help="random HSV gains")
    p.add_argument("--device_mosaic", action="store_true",
                   help="run mosaic on the device, partners from the batch")
    p.add_argument("--device_augment", action="store_true",
                   help="run HSV (with --hsv), color jitter and flips on the "
                        "device; the host keeps rotate, blur and CLAHE")
    p.add_argument("--multi_scale", type=str, default="auto",
                   help="comma-separated sizes, or 'auto' for {0.8, 0.9, "
                        "1.0}x image_size (512/576/640 at 640), or 'off'; "
                        "ignored with --rect")
    p.add_argument("--no_multi_scale", action="store_true")
    p.add_argument("--lr_schedule", type=str, default="constant",
                   choices=["constant", "cosine"])
    p.add_argument("--warmup_epochs", type=float, default=0.0)
    p.add_argument("--autoanchor", action="store_true",
                   help="refit anchors by k-means when the defaults' "
                        "best-possible recall is below 0.98")
    p.add_argument("--label_smoothing", type=float, default=0.0)
    p.add_argument("--focal_gamma", type=float, default=0.0)
    p.add_argument("--remat", action="store_true",
                   help="recompute the C3 stacks in the backward pass")
    p.add_argument("--no_remat", action="store_true",
                   help="no automatic remat at >= 96 images of 640^2 a "
                        "device")
    p.add_argument("--guard_nonfinite", action="store_true",
                   help="skip optimizer updates whose gradients are NaN/inf")
    p.add_argument("--confusion", action="store_true",
                   help="write a per-class confusion-matrix CSV every epoch")
    p.add_argument("--coco_dump", type=str, default=None,
                   help="directory for COCO-format eval dumps")
    p.add_argument("--synth_steps", type=int, default=50,
                   help="--data synth: train batches per epoch")
    p.add_argument("--synth_val_batches", type=int, default=8,
                   help="--data synth: fixed eval-set size in batches")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel ranks, one a device (0 = every "
                        "visible card; one process on the CPU); must divide "
                        "--bs")
    p.add_argument("--sp", type=int, default=1,
                   help="spatial parallelism: image rows over N devices")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor parallelism: output channels over N devices")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline parallelism: the model's stages over N "
                        "devices")
    p.add_argument("--pp_micro", type=int, default=0,
                   help="--pp: micro-batches a step (0: --pp)")
    # refused (see REFUSED)
    p.add_argument("--flat_opt", action="store_true")
    p.add_argument("--no_flat_opt", action="store_true",
                   help=argparse.SUPPRESS)  # JAX's legacy no-op
    return p.parse_args(argv)


def check_supported(opt) -> None:
    """Raise SystemExit, before any work, for every option the port cannot
    run."""
    for flag, is_set, needs in REFUSED:
        if is_set(opt):
            raise SystemExit(f"--{flag} is not supported by the port yet: it "
                             f"needs {needs}")
    grids = [f"--{k} {getattr(opt, k)}" for k in ("sp", "tp", "pp")
             if getattr(opt, k) > 1]
    if len(grids) > 1:
        raise SystemExit(f"{' and '.join(grids)}: --sp, --tp and --pp are "
                         "mutually exclusive (only --dp composes with one)")
    if opt.sp > 1:
        # as in JAX, every train size must split into --sp row shards; a
        # --rect batch whose height does not raises at its step
        bad = [s for s in multiscale_sizes(opt) or [opt.image_size]
               if s % opt.sp]
        if bad:
            raise SystemExit(f"--sp {opt.sp}: train sizes {bad} are not "
                             f"divisible by {opt.sp} (the image rows split "
                             "into --sp shards); set --image_size or "
                             "--multi_scale")
    if opt.autoanchor and opt.data == "synth":
        raise SystemExit("--autoanchor needs a disk dataset to measure box "
                         "statistics; not supported with --data synth")


def _scalar(token: str) -> str:
    token = token.strip()
    if len(token) >= 2 and token[0] == token[-1] and token[0] in "'\"":
        return token[1:-1]
    return token


def read_data_yaml(path: str):
    """(nc, names) from a data.yaml: with PyYAML where it is installed,
    else by a reader of the two keys as data.yaml files write them
    (``nc: 80``; ``names:`` as a flow list ``[a, 'b']``, which may span
    lines, or as a block list of ``- a`` lines)."""
    with open(path) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        yaml = None
    if yaml is not None:
        data = yaml.safe_load(text)
        return int(data["nc"]), list(data["names"])
    nc, names = None, None
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i]
        i += 1
        if not line.strip() or line[0].isspace() or line.startswith("#"):
            continue
        key, _, value = line.partition(":")
        value = value.split(" #")[0].strip()
        if key.strip() == "nc":
            nc = int(value)
        elif key.strip() == "names" and value.startswith("["):
            while not value.endswith("]") and i < len(lines):
                value += " " + lines[i].split(" #")[0].strip()
                i += 1
            names = [_scalar(t) for t in value[1:-1].split(",") if t.strip()]
        elif key.strip() == "names":
            names = []
            while i < len(lines) and lines[i].lstrip().startswith("- "):
                names.append(_scalar(lines[i].lstrip()[2:].split(" #")[0]))
                i += 1
    if nc is None or names is None:
        raise ValueError(f"{path}: no 'nc' or 'names' key")
    return nc, names


def resolve_dataset(opt):
    """(root, nc, labels): the disk root datasets/{data} (or under
    --datasets_dir) with nc and names from its data.yaml, COCO's when it
    has none; for --data synth no root and the COCO classes."""
    from yolov5m_tpu_torch.config import COCO_LABELS

    if opt.data == "synth":
        return None, len(COCO_LABELS), list(COCO_LABELS)
    root = os.path.join(opt.datasets_dir or os.path.join(os.getcwd(),
                                                         "datasets"),
                        opt.data)
    yaml_path = os.path.join(root, "data.yaml")
    if os.path.isfile(yaml_path):
        nc, names = read_data_yaml(yaml_path)
        return root, nc, names
    return root, len(COCO_LABELS), list(COCO_LABELS)


def multiscale_sizes(opt):
    """The train buckets the flags ask for, or None for a fixed size (and
    always under --rect)."""
    from yolov5m_tpu_torch.data.loaders import default_multiscale_sizes

    if opt.image_size % 32:
        raise SystemExit(f"--image_size {opt.image_size} must be a multiple "
                         "of 32")
    ms = "off" if opt.no_multi_scale else opt.multi_scale
    if opt.rect or ms in ("", "off"):
        return None
    if ms == "auto":
        return default_multiscale_sizes(opt.image_size)
    sizes = [int(s) for s in ms.split(",")]
    bad = [s for s in sizes if s % 32]
    if bad:
        raise SystemExit("--multi_scale sizes must be multiples of 32 (the "
                         f"deepest stride); got {bad}")
    return sizes


def wants_remat(opt, n_devices: int = 1) -> bool:
    """--remat, or on by itself from AUTO_REMAT_LOAD images of 640^2 a
    device (the global --bs over n_devices ranks) unless --no_remat."""
    if opt.remat:
        return True
    load = opt.bs / n_devices * (opt.image_size / 640.0) ** 2
    return not opt.no_remat and load >= AUTO_REMAT_LOAD


def resolve_dp(opt, kind: str) -> int:
    """The number of data-parallel ranks --dp asks for; SystemExit, before
    any work, when the devices are too few or the count does not divide
    --bs."""
    from yolov5m_tpu_torch.parallel.dp import make_mesh

    try:
        n = len(make_mesh(opt.dp or None, kind))
    except ValueError as e:
        raise SystemExit(f"--dp {opt.dp}: {e}")
    if opt.bs % n:
        raise SystemExit(f"--bs {opt.bs} is not divisible by --dp {n}: each "
                         "rank takes bs/dp rows of the global batch")
    return n


def device_augment_step(opt, device_mosaic: bool, device_augment: bool,
                        rank: int = 0, world: int = 1):
    """The train loop's device augmentation as fn(seed, image, labels,
    mask) -> (image, labels, mask), or None when nothing runs there. Its
    draws come from a generator on the images' device seeded with
    ``seed * world + rank``: each rank of a data-parallel run draws its
    own, and one process draws from ``seed``."""
    if not ((device_mosaic and opt.mosaic > 0) or device_augment):
        return None
    from yolov5m_tpu_torch.ops.augment_device import device_augment_batch

    flip = 0.5 if device_augment else 0.0
    kw = dict(mosaic_p=opt.mosaic if device_mosaic else 0.0,
              hsv=opt.hsv and device_augment, hflip_p=flip, vflip_p=flip,
              # the reference's ColorJitter p; rotate stays on the host
              cj_p=0.4 if device_augment else 0.0)

    def step(seed, image, labels, mask):
        gen = torch.Generator(device=image.device)
        gen.manual_seed(seed * world + rank)
        return device_augment_batch(gen, image, labels, mask, **kw)

    return step


def resolve_grid(opt, kind: str):
    """The device grid --sp, --tp or --pp asks for (with --dp as its data
    axis), or None; SystemExit, before any work, when the devices are too
    few or --dp does not divide --bs."""
    from yolov5m_tpu_torch.parallel import mesh as meshes

    n, flag = next(((getattr(opt, k), k) for k in ("sp", "tp", "pp")
                    if getattr(opt, k) > 1), (1, None))
    if flag is None:
        return None
    have = torch.cuda.device_count() if kind == "cuda" else 1
    # as in the JAX CLI: SP and TP fill the cards with data rows, PP
    # takes data rows only from --dp
    n_data = (max(opt.dp, 1) if flag == "pp"
              else opt.dp or max(have // n, 1))
    micro = (opt.pp_micro or opt.pp) if flag == "pp" else 1
    if opt.bs % (micro * n_data):
        raise SystemExit(f"--bs {opt.bs} is not divisible by pp_micro x dp "
                         f"= {micro} x {n_data}" if flag == "pp" else
                         f"--bs {opt.bs} is not divisible by --dp {n_data}")
    try:
        if flag == "pp":
            return (meshes.make_dp_pp_mesh(n_data, n, device=kind)
                    if n_data > 1 else meshes.make_pp_mesh(n, device=kind))
        make = meshes.make_sp_mesh if flag == "sp" else meshes.make_tp_mesh
        return make(n_data, n, device=kind)
    except ValueError as e:
        raise SystemExit(f"--{flag} {n} over {n_data} data rows: {e}")


def main(opt):
    """Run the CLI: in this process (on one device, or with --sp, --tp or
    --pp on a grid of them), or with --dp above 1 alone in one spawned
    process a device."""
    from yolov5m_tpu_torch.config import require_device
    from yolov5m_tpu_torch.parallel.dp import free_port

    check_supported(opt)
    if not opt.nosaveimgs:
        # a class name the images cannot draw stops the run before any work
        from yolov5m_tpu_torch.utils.plotting import check_labels
        check_labels(resolve_dataset(opt)[2])
    device = require_device(opt.device)
    mesh = resolve_grid(opt, device.type)
    if mesh is not None:
        return train(opt, mesh.devices.flat[0], mesh=mesh)
    n = resolve_dp(opt, device.type)
    if n == 1:
        return train(opt, device)
    import torch.multiprocessing as mp

    print(f"==> data-parallel over {n} {device.type} devices "
          f"({opt.bs // n} of the global --bs {opt.bs} a rank)", flush=True)
    mp.spawn(rank_main, args=(n, opt, device.type,
                              f"tcp://127.0.0.1:{free_port()}"),
             nprocs=n, join=True)


def rank_main(rank: int, world: int, opt, kind: str, url: str) -> None:
    """One rank of a data-parallel run: join the group at ``url`` (NCCL
    on cuda:rank, gloo on the CPU), train, leave the group."""
    import torch.distributed as dist

    from yolov5m_tpu_torch.parallel.dp import initialize_multihost

    if kind == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    initialize_multihost(url, world, rank,
                         backend="nccl" if kind == "cuda" else "gloo")
    try:
        train(opt, device, rank, world)
    finally:
        dist.destroy_process_group()


def train(opt, device, rank: int = 0, world: int = 1, mesh=None):
    """The run on one device: a single process, or, where a process group
    is initialized, its rank ``rank`` of ``world`` (the DP trainer, even
    at world size 1); with ``mesh`` (resolve_grid), the SP, TP or PP
    trainer over it, the master state on ``device``, its first device."""
    import torch.distributed as dist

    from yolov5m_tpu_torch.config import ANCHORS, Config
    from yolov5m_tpu_torch.eval.evaluator import Evaluator
    from yolov5m_tpu_torch.models.yolo import (FAMILY, YOLOv5,
                                               normalized_anchors)
    from yolov5m_tpu_torch.train.loss import LossConfig, YoloLoss
    from yolov5m_tpu_torch.train.trainer import (Trainer, YoloAdam,
                                                 accumulation_steps)
    from yolov5m_tpu_torch.utils.checkpoint import (AsyncCheckpointer,
                                                    latest_epoch,
                                                    load_checkpoint,
                                                    next_run_name)
    from yolov5m_tpu_torch.parallel.dp import replicate_state
    from yolov5m_tpu_torch.utils.logging import CSVLogger

    lead = rank == 0                    # evaluates, writes and prints
    group = dist.group.WORLD if dist.is_initialized() else None
    say = print if lead else (lambda *a, **k: None)

    def from_lead(value):
        """rank 0's value on every rank."""
        if group is None:
            return value
        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    root, nc, labels = resolve_dataset(opt)
    if opt.max_boxes is None:
        # the synthetic painter is a loop over capacity; disk labels keep
        # the reference's 120
        opt.max_boxes = 8 if opt.data == "synth" else 120
    fam_fo, fam_dm = FAMILY[opt.model]
    first_out = opt.first_out if opt.first_out is not None else fam_fo
    cfg = Config(first_out=first_out, nc=nc, image_size=opt.image_size,
                 epochs=opt.epochs, batch_size=opt.bs,
                 max_boxes_per_image=opt.max_boxes, iou_type=opt.iou_type,
                 guard_nonfinite=opt.guard_nonfinite,
                 label_smoothing=opt.label_smoothing,
                 focal_gamma=opt.focal_gamma)
    ms_sizes = multiscale_sizes(opt)
    if ms_sizes:
        say(f"==> multi-scale buckets: {ms_sizes}")
    n_devices = world
    if mesh is not None and opt.pp == 1:
        # rows or channels split the activations too; PP's per-device
        # stash (a stage's share, times the micro-batches in flight) does
        # not fit the rule: --remat for it
        n_devices = mesh.size
    elif mesh is not None:
        n_devices = mesh.size // opt.pp
    remat = wants_remat(opt, n_devices)
    if remat and not opt.remat:
        say(f"==> auto-enabling --remat (>= {AUTO_REMAT_LOAD} images of "
            "640^2 a device; --no_remat to opt out)")

    anchors_px = np.asarray(ANCHORS, np.float32)
    if opt.autoanchor and lead:
        from yolov5m_tpu_torch.data.autoanchor import check_and_fit
        from yolov5m_tpu_torch.data.dataset import DetectionDataset
        aa_ds = DetectionDataset(root, train=True, default_size=cfg.image_size,
                                 bs=opt.bs, bboxes_format=opt.box_format,
                                 max_boxes=opt.max_boxes)
        anchors_px, aa_info = check_and_fit(aa_ds, anchors_px,
                                            image_size=cfg.image_size,
                                            anchor_t=cfg.anchor_t)
        if aa_info["refit"]:
            print(f"==> autoanchor: refit (BPR {aa_info['bpr_default']:.3f} "
                  f"-> {aa_info['bpr_fitted']:.3f}) over "
                  f"{aa_info['n_boxes']} boxes:\n{anchors_px.tolist()}")
        else:
            print(f"==> autoanchor: defaults kept "
                  f"(BPR {aa_info['bpr_default']:.3f})")
    anchors_px = from_lead(anchors_px)

    device_mosaic, device_augment = opt.device_mosaic, opt.device_augment
    if opt.rect and (device_mosaic or device_augment):
        # the device step runs on square batches only, and the host loader
        # would already have dropped the augmentations it replaces
        say("==> --rect batches are non-square: device mosaic/augment "
            "don't apply; keeping host-side augmentation")
        device_mosaic = device_augment = False
    if opt.data == "synth":
        from yolov5m_tpu_torch.data.synthetic import SyntheticLoader
        train_loader = SyntheticLoader(opt.bs, steps=opt.synth_steps,
                                       image_size=opt.image_size, nc=nc,
                                       max_boxes=opt.max_boxes,
                                       multi_scale_sizes=ms_sizes,
                                       device=device, rank=rank,
                                       world_size=world)
        val_loader = SyntheticLoader(opt.bs, steps=opt.synth_val_batches,
                                     image_size=opt.image_size, nc=nc,
                                     max_boxes=opt.max_boxes, train=False,
                                     device=device)
        say(f"==> synthetic on-device data: {len(train_loader)} train "
            f"batches/epoch, {len(val_loader)} fixed eval batches")
    else:
        from yolov5m_tpu_torch.data.loaders import get_loaders
        train_loader, val_loader = get_loaders(
            root, opt.bs, rect_training=opt.rect, box_format=opt.box_format,
            max_boxes=opt.max_boxes, default_size=opt.image_size,
            multi_scale_sizes=ms_sizes, num_workers=opt.nw,
            mosaic_p=0.0 if device_mosaic else opt.mosaic,
            hsv=opt.hsv and not device_augment,
            device_augment=device_augment, rank=rank, world_size=world)
        say(f"==> {root}: {len(train_loader)} train batches/epoch, "
            f"{len(val_loader)} val batches")

    ckpt_root = "SAVED_CHECKPOINT"
    starting_epoch, last = 1, None
    if opt.resume:
        filename = opt.filename or "model_1"
        last = latest_epoch(ckpt_root, filename)
        if last is None:
            raise SystemExit(f"--resume: no checkpoints under "
                             f"{ckpt_root}/{filename}")
        starting_epoch = last + 1
    else:
        filename = from_lead(opt.filename or next_run_name(ckpt_root))

    # the anchors live with the run: a refit is saved to the run folder and
    # reloaded on --resume, so loss and decode keep the trained anchors
    anchors_path = os.path.join(ckpt_root, filename, "anchors.json")
    if opt.resume and os.path.isfile(anchors_path):
        with open(anchors_path) as f:
            anchors_px = np.asarray(json.load(f), np.float32)
        say(f"==> loaded run anchors from {anchors_path}")
    elif lead and not np.array_equal(anchors_px,
                                     np.asarray(ANCHORS, np.float32)):
        os.makedirs(os.path.dirname(anchors_path), exist_ok=True)
        with open(anchors_path, "w") as f:
            json.dump(anchors_px.tolist(), f)
        print(f"==> saved refit anchors to {anchors_path}")

    accumulate = accumulation_steps(opt.bs, cfg.nominal_batch_size)
    if opt.pp > 1:
        # PP updates once a loader batch (its micro-batches are the
        # accumulation), so the schedule counts loader batches
        accumulate = 1
    opt_steps_per_epoch = max(len(train_loader) // accumulate, 1)
    if opt.lr_schedule != "constant":
        cfg = dataclasses.replace(
            cfg, lr_schedule=opt.lr_schedule,
            warmup_steps=int(opt.warmup_epochs * opt_steps_per_epoch))
    total_epochs = (starting_epoch - 1) + opt.epochs

    compute_dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                     else torch.float32)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)              # the random init, from a seed
        model = YOLOv5(first_out=cfg.first_out, nc=cfg.nc, depth_mult=fam_dm,
                       compute_dtype=compute_dtype, remat=remat)
    model = model.to(device=device, memory_format=torch.channels_last)
    loss_fn = YoloLoss(LossConfig.from_config(cfg), anchors_px,
                       kind="ultralytics" if opt.ultralytics_loss else "custom")
    optimizer = YoloAdam(model.parameters(), cfg,
                         total_steps=total_epochs * opt_steps_per_epoch)
    if mesh is None:
        trainer = Trainer(model, loss_fn, optimizer, accumulate, group=group)
    else:
        trainer = grid_trainer(opt, mesh, model, loss_fn, optimizer,
                               accumulate)
    if opt.resume:
        trainer.load_state_dict(load_checkpoint(ckpt_root, filename, last,
                                                map_location=device))
        say(f"==> resumed {filename} at epoch {last}")
    if opt.load_coco_weights:
        with np.load(opt.weights) as z:
            sd = {k: torch.from_numpy(z[k]).float() for k in z.files}
        model.load_state_dict(sd, strict=True)
        trainer.reset_ema()                  # a copy, not the old EMA
        say(f"==> loaded torch-layout weights from {opt.weights}")
    if group is not None:
        replicate_state(trainer, group)

    save_logs = not opt.nosavelogs and lead
    logger = (CSVLogger("train_eval_metrics", filename, resume=opt.resume)
              if save_logs else None)
    anchors_norm = normalized_anchors(anchors=anchors_px)
    evaluator = Evaluator(model, anchors_norm, cfg, anchors_px)
    checkpointer = AsyncCheckpointer()
    augment = device_augment_step(opt, device_mosaic, device_augment, rank,
                                  world)

    try:
        for epoch in range(starting_epoch, opt.epochs + starting_epoch):
            train_loader.set_epoch(epoch)
            if not opt.only_eval:
                train_epoch(trainer, train_loader, epoch, opt.bs, logger,
                            device, augment, verbose=lead)
            if not lead:
                dist.barrier()               # rank 0 evaluates and saves
                if opt.only_eval:
                    break
                continue
            eval_sd = trainer.eval_state_dict()
            results = evaluator.run(
                eval_sd, val_loader, coco_dump_dir=opt.coco_dump,
                class_names=labels,
                confusion_csv=(os.path.join("train_eval_metrics", filename,
                                            f"confusion_epoch_{epoch}.csv")
                               if opt.confusion and save_logs else None))
            print(f"Class accuracy: {results['class_accuracy'] * 100:.2f}%")
            print(f"Obj accuracy: {results['obj_accuracy'] * 100:.2f}%")
            print(f"MAP50: {results['map50']:.4f}, "
                  f"MAP75: {results['map75']:.4f}")
            if save_logs:
                logger.log_eval(epoch, results["class_accuracy"],
                                results["obj_accuracy"], results["map50"],
                                results["map75"])
            if not opt.nosaveimgs:
                dump_prediction_images(evaluator.fused_model(eval_sd),
                                       anchors_norm, cfg, val_loader,
                                       filename, epoch, labels)
            if opt.only_eval:
                print("==> --only_eval: done after one evaluation pass")
                if group is not None:
                    dist.barrier()
                break
            if not opt.nosavemodel:
                checkpointer.save(trainer.state_dict(), ckpt_root, filename,
                                  epoch, best_metric=results["map50"])
                print("=> Saving checkpoint (async)...")
            if group is not None:
                dist.barrier()
    finally:
        checkpointer.wait()
        for loader in (train_loader, val_loader):
            if hasattr(loader, "close"):
                loader.close()


def grid_trainer(opt, mesh, model, loss_fn, optimizer, accumulate: int):
    """The SP, TP or PP trainer over ``mesh`` (resolve_grid). PP applies
    one update a step (its micro-batches are the accumulation), as the JAX
    CLI's does."""
    from yolov5m_tpu_torch import parallel

    data_axis = "data" if "data" in mesh.axis_names else None
    if opt.sp > 1:
        print(f"==> spatially partitioned training over a {mesh.shape} grid")
        return parallel.make_sp_train_step(model, loss_fn, optimizer, mesh,
                                           accumulate, data_axis=data_axis)
    if opt.tp > 1:
        print(f"==> tensor-parallel training over a {mesh.shape} grid")
        return parallel.make_tp_train_step(model, loss_fn, optimizer, mesh,
                                           accumulate, data_axis=data_axis)
    micro = opt.pp_micro or opt.pp
    n_data = mesh.shape.get("data", 1)
    mb = opt.bs // (micro * n_data)
    print(f"==> pipeline-parallel training over a {mesh.shape} grid: "
          f"{micro} micro-batches of {mb} a replica a step")
    return parallel.make_pp_train_step(
        model, loss_fn, optimizer, mesh, mb, micro,
        image_hw=(opt.image_size, opt.image_size), data_axis=data_axis)


def train_epoch(trainer, loader, epoch: int, bs: int, logger, device,
                augment=None, verbose: bool = True) -> None:
    """One epoch of micro-batches; prints every 10 steps (unless not
    ``verbose``), logs parts every 100. The loss scalars come back to the
    host once per print, not per step. ``augment`` (device_augment_step)
    runs on square batches. ``bs`` is the global batch."""
    from yolov5m_tpu_torch.data.loaders import to_device

    t0 = t_step = time.time()
    epoch_loss, nb, chunk = 0.0, 0, []
    for idx, batch in enumerate(loader):
        image, labels, mask = (to_device(batch[k], device)
                               for k in ("image", "labels", "mask"))
        if augment is not None and image.shape[1] == image.shape[2]:
            image, labels, mask = augment(epoch * 100000 + idx, image,
                                          labels, mask)
        metrics = trainer.train_step(image, labels, mask)
        chunk.append(metrics["loss"])
        nb += 1
        if idx % 10 == 0:                    # the host waits here
            losses = torch.stack(chunk).cpu().numpy()
            epoch_loss += float(losses.sum())
            chunk = []
            dt = time.time() - t_step
            ips = 10 * bs / dt if idx else bs / dt
            t_step = time.time()
            if verbose:
                print(f"epoch {epoch} [{idx}/{len(loader)}] loss "
                      f"{float(losses[-1]):.4f} gnorm "
                      f"{float(metrics['grad_norm']):.2f} {ips:.1f} img/s",
                      flush=True)
        if logger is not None and idx % 100 == 0:
            logger.log_loss(epoch, idx, float(metrics["box"]),
                            float(metrics["obj"]), float(metrics["cls"]))
    if chunk:
        epoch_loss += float(torch.stack(chunk).sum())
    if verbose:
        print(f"==> epoch {epoch} training_loss: "
              f"{epoch_loss / max(nb, 1):.2f} ({time.time() - t0:.0f}s)")


@torch.no_grad()
def dump_prediction_images(fused_model, anchors_norm, cfg, val_loader,
                           filename: str, epoch: int, labels,
                           num_images: int = 5) -> None:
    """GT-vs-prediction images of the first val batch under
    SAVED_IMAGES/{filename}/EPOCH_{epoch}, at the reference's plotting
    thresholds (iou 0.45, conf 0.25)."""
    from yolov5m_tpu_torch.data.loaders import to_device
    from yolov5m_tpu_torch.ops.boxes import xywhn_to_xyxy_np
    from yolov5m_tpu_torch.ops.decode import decode_predictions
    from yolov5m_tpu_torch.ops.nms import batched_nms
    from yolov5m_tpu_torch.utils.plotting import save_prediction_images

    batch = next(iter(val_loader))
    dev = fused_model.backbone[0].cbl[0].weight.device
    preds = fused_model(to_device(batch["image"], dev))
    rows = decode_predictions(preds, torch.as_tensor(anchors_norm).to(dev))
    det, valid = batched_nms(rows, 0.45, 0.25, cfg.max_detections,
                             cfg.pre_nms_topk)
    det, valid = det.cpu().numpy(), valid.cpu().numpy()
    images = np.asarray(torch.as_tensor(batch["image"]).cpu())
    h, w = images.shape[1:3]
    pred_rows, gt_rows = [], []
    for b in range(min(num_images, det.shape[0])):
        pred_rows.append(det[b][valid[b]])
        gt = batch["labels"][b][batch["mask"][b]]
        xyxy = xywhn_to_xyxy_np(gt[:, 1:5], w=w, h=h)
        gt_rows.append(np.concatenate(
            [gt[:, :1], np.ones((len(gt), 1), np.float32), xyxy], axis=1))
    n = save_prediction_images(images, pred_rows, gt_rows, "SAVED_IMAGES",
                               filename, epoch, labels, num_images)
    print(f"=> Saved {n} prediction images")


def cli():
    """Console-script entry point."""
    main(arg_parser())


if __name__ == "__main__":
    cli()
