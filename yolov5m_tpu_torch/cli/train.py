"""Training CLI: port of ``yolov5m_tpu/cli/train.py``, single device,
``--data synth``.

Each epoch trains on the on-device synthetic stream (data/synthetic.py),
evaluates the EMA weights through the fused detection path (the CUDA NMS
kernel on the card, conf 0.01, K 1024), appends eval.csv and writes
SAVED_CHECKPOINT/{run}/checkpoint_epoch_{e}.pt in the background. The
model trains with f32 weights and bf16 activations (explicit casts, no
GradScaler), as the JAX CLI does; there is no rematerialization, so the
JAX CLI's automatic remat at large batches is not applied either.

Usage (on a machine with a CUDA card):
  python -m yolov5m_tpu_torch.cli.train --data synth --nosaveimgs \\
      --bs 16 --epochs 3 --synth_steps 50

Flags of the JAX CLI that need modules the port does not have yet are
refused with SystemExit and the ROADMAP item that brings them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

# flag -> (is it set?, what it needs): refused until the port has it
REFUSED = (
    ("rect", lambda o: o.rect, "disk datasets (ROADMAP queue 1 item 12)"),
    ("mosaic", lambda o: o.mosaic > 0, "mosaic (ROADMAP queue 1 item 12)"),
    ("hsv", lambda o: o.hsv, "device augmentation (ROADMAP queue 1 item 12)"),
    ("device_mosaic", lambda o: o.device_mosaic,
     "device mosaic (ROADMAP queue 1 item 12)"),
    ("device_augment", lambda o: o.device_augment,
     "device augmentation (ROADMAP queue 1 item 12)"),
    ("autoanchor", lambda o: o.autoanchor,
     "disk datasets for box statistics (ROADMAP queue 1 item 12)"),
    ("dp", lambda o: o.dp > 1, "data parallelism (ROADMAP queue 1 item 13)"),
    ("sp", lambda o: o.sp > 1, "SP/TP/PP (ROADMAP queue 1 item 15)"),
    ("tp", lambda o: o.tp > 1, "SP/TP/PP (ROADMAP queue 1 item 15)"),
    ("pp", lambda o: o.pp > 1, "SP/TP/PP (ROADMAP queue 1 item 15)"),
    ("remat", lambda o: o.remat,
     "rematerialization (ROADMAP queue 1 item 2)"),
    ("flat_opt", lambda o: o.flat_opt,
     "nothing: it only resumes JAX checkpoints, which the port cannot read"),
)


def arg_parser(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", type=str, default="coco",
                   help="'synth' for the on-device synthetic stream, the "
                        "only data the port trains on so far")
    p.add_argument("--nosaveimgs", action="store_true",
                   help="required: prediction images need matplotlib")
    p.add_argument("--nosavemodel", action="store_true")
    p.add_argument("--nosavelogs", action="store_true")
    p.add_argument("--epochs", type=int, default=273)
    p.add_argument("--ultralytics_loss", action="store_true")
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
                   help="label capacity per image (default 8 for --data synth)")
    p.add_argument("--iou_type", type=str, default="giou",
                   choices=["giou", "ciou", "diou", "iou"])
    p.add_argument("--multi_scale", type=str, default="auto",
                   help="comma-separated sizes, or 'auto' for {0.8, 0.9, "
                        "1.0}x image_size (512/576/640 at 640), or 'off'")
    p.add_argument("--no_multi_scale", action="store_true")
    p.add_argument("--lr_schedule", type=str, default="constant",
                   choices=["constant", "cosine"])
    p.add_argument("--warmup_epochs", type=float, default=0.0)
    p.add_argument("--label_smoothing", type=float, default=0.0)
    p.add_argument("--focal_gamma", type=float, default=0.0)
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
    # refused in this version of the port (see REFUSED)
    p.add_argument("--rect", action="store_true")
    p.add_argument("--mosaic", type=float, default=0.0)
    p.add_argument("--hsv", action="store_true")
    p.add_argument("--device_mosaic", action="store_true")
    p.add_argument("--device_augment", action="store_true")
    p.add_argument("--autoanchor", action="store_true")
    p.add_argument("--dp", type=int, default=0)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--flat_opt", action="store_true")
    return p.parse_args(argv)


def check_supported(opt) -> None:
    """Raise SystemExit for every option the port cannot run yet."""
    if opt.data != "synth":
        raise SystemExit(f"--data {opt.data}: the port trains on --data synth "
                         "only; disk datasets wait for ROADMAP queue 1 item 12")
    for flag, is_set, needs in REFUSED:
        if is_set(opt):
            raise SystemExit(f"--{flag} is not supported by the port yet: it "
                             f"needs {needs}")
    if not opt.nosaveimgs:
        raise SystemExit("prediction images need matplotlib "
                         "(utils/plotting.py, not ported yet): pass "
                         "--nosaveimgs")


def multiscale_sizes(opt):
    """The train buckets the flags ask for, or None for a fixed size."""
    from yolov5m_tpu_torch.data.loaders import default_multiscale_sizes

    if opt.image_size % 32:
        raise SystemExit(f"--image_size {opt.image_size} must be a multiple "
                         "of 32")
    ms = "off" if opt.no_multi_scale else opt.multi_scale
    if ms in ("", "off"):
        return None
    if ms == "auto":
        return default_multiscale_sizes(opt.image_size)
    sizes = [int(s) for s in ms.split(",")]
    bad = [s for s in sizes if s % 32]
    if bad:
        raise SystemExit("--multi_scale sizes must be multiples of 32 (the "
                         f"deepest stride); got {bad}")
    return sizes


def main(opt):
    from yolov5m_tpu_torch.config import (ANCHORS, COCO_LABELS, Config,
                                          require_device)
    from yolov5m_tpu_torch.data.synthetic import SyntheticLoader
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
    from yolov5m_tpu_torch.utils.logging import CSVLogger

    check_supported(opt)
    device = require_device(opt.device)
    labels = list(COCO_LABELS)
    nc = len(labels)
    max_boxes = opt.max_boxes if opt.max_boxes is not None else 8
    fam_fo, fam_dm = FAMILY[opt.model]
    first_out = opt.first_out if opt.first_out is not None else fam_fo
    cfg = Config(first_out=first_out, nc=nc, image_size=opt.image_size,
                 epochs=opt.epochs, batch_size=opt.bs,
                 max_boxes_per_image=max_boxes, iou_type=opt.iou_type,
                 guard_nonfinite=opt.guard_nonfinite,
                 label_smoothing=opt.label_smoothing,
                 focal_gamma=opt.focal_gamma)
    ms_sizes = multiscale_sizes(opt)
    if ms_sizes:
        print(f"==> multi-scale buckets: {ms_sizes}")

    train_loader = SyntheticLoader(opt.bs, steps=opt.synth_steps,
                                   image_size=opt.image_size, nc=nc,
                                   max_boxes=max_boxes,
                                   multi_scale_sizes=ms_sizes, device=device)
    val_loader = SyntheticLoader(opt.bs, steps=opt.synth_val_batches,
                                 image_size=opt.image_size, nc=nc,
                                 max_boxes=max_boxes, train=False,
                                 device=device)
    print(f"==> synthetic on-device data: {len(train_loader)} train "
          f"batches/epoch, {len(val_loader)} fixed eval batches")

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
        filename = opt.filename or next_run_name(ckpt_root)

    accumulate = accumulation_steps(opt.bs, cfg.nominal_batch_size)
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
                       compute_dtype=compute_dtype)
    model = model.to(device=device, memory_format=torch.channels_last)
    anchors_px = np.asarray(ANCHORS, np.float32)
    loss_fn = YoloLoss(LossConfig.from_config(cfg), anchors_px,
                       kind="ultralytics" if opt.ultralytics_loss else "custom")
    trainer = Trainer(model, loss_fn,
                      YoloAdam(model.parameters(), cfg,
                               total_steps=total_epochs * opt_steps_per_epoch),
                      accumulate)
    if opt.resume:
        trainer.load_state_dict(load_checkpoint(ckpt_root, filename, last,
                                                map_location=device))
        print(f"==> resumed {filename} at epoch {last}")
    if opt.load_coco_weights:
        with np.load(opt.weights) as z:
            sd = {k: torch.from_numpy(z[k]).float() for k in z.files}
        model.load_state_dict(sd, strict=True)
        trainer.reset_ema()                  # a copy, not the old EMA
        print(f"==> loaded torch-layout weights from {opt.weights}")

    save_logs = not opt.nosavelogs
    logger = (CSVLogger("train_eval_metrics", filename, resume=opt.resume)
              if save_logs else None)
    evaluator = Evaluator(model, normalized_anchors(anchors=anchors_px), cfg,
                          anchors_px)
    checkpointer = AsyncCheckpointer()

    try:
        for epoch in range(starting_epoch, opt.epochs + starting_epoch):
            train_loader.set_epoch(epoch)
            if not opt.only_eval:
                train_epoch(trainer, train_loader, epoch, opt.bs, logger,
                            device)
            results = evaluator.run(
                trainer.eval_state_dict(), val_loader,
                coco_dump_dir=opt.coco_dump, class_names=labels,
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
            if opt.only_eval:
                print("==> --only_eval: done after one evaluation pass")
                break
            if not opt.nosavemodel:
                checkpointer.save(trainer.state_dict(), ckpt_root, filename,
                                  epoch, best_metric=results["map50"])
                print("=> Saving checkpoint (async)...")
    finally:
        checkpointer.wait()


def train_epoch(trainer, loader, epoch: int, bs: int, logger, device) -> None:
    """One epoch of micro-batches; prints every 10 steps, logs parts every
    100. The loss scalars come back to the host once per print, not per
    step."""
    t0 = t_step = time.time()
    epoch_loss, nb, chunk = 0.0, 0, []
    for idx, batch in enumerate(loader):
        metrics = trainer.train_step(
            batch["image"], torch.as_tensor(batch["labels"]).to(device),
            torch.as_tensor(batch["mask"]).to(device))
        chunk.append(metrics["loss"])
        nb += 1
        if idx % 10 == 0:
            losses = torch.stack(chunk).cpu().numpy()
            epoch_loss += float(losses.sum())
            chunk = []
            dt = time.time() - t_step
            ips = 10 * bs / dt if idx else bs / dt
            t_step = time.time()
            print(f"epoch {epoch} [{idx}/{len(loader)}] loss "
                  f"{float(losses[-1]):.4f} gnorm "
                  f"{float(metrics['grad_norm']):.2f} {ips:.1f} img/s",
                  flush=True)
        if logger is not None and idx % 100 == 0:
            logger.log_loss(epoch, idx, float(metrics["box"]),
                            float(metrics["obj"]), float(metrics["cls"]))
    if chunk:
        epoch_loss += float(torch.stack(chunk).sum())
    print(f"==> epoch {epoch} training_loss: {epoch_loss / max(nb, 1):.2f} "
          f"({time.time() - t0:.0f}s)")


def cli():
    """Console-script entry point."""
    main(arg_parser())


if __name__ == "__main__":
    cli()
