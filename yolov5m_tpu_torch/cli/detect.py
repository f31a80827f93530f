"""Inference CLI: port of ``yolov5m_tpu/cli/detect.py``.

One image (--img, or a random pick from --img_dir), or every image of
--img_dir with --all: host decode and letterbox, uint8 batches of --bs to
the device, one forward per batch, ``fused_detect`` (its NMS is the CUDA
kernel on the card), and detections mapped back to each source image.
--save_pred writes annotated images and, with --all, detections.json
under --out. JPEG, PNG, BMP, GIF, WebP, PNM (P1-P6 at every maxval, Pf)
and TIFF (every compression Pillow's open knows: uncompressed, LZW,
deflate, PackBits, JPEG at 8 and 12 bits, old-style JPEG, ZSTD, LZMA,
CCITT fax, ThunderScan; YCbCr and CIELab among them; strips, tiles,
planes) decode with the port's decoders, as the JAX CLI's libjpeg and
Pillow decode them (all without PIL); other formats (the long tail) need
PIL.

--int8: post-training int8 quantization (``models/quantize.py``, the int8
activation chain) of the BN-folded model, calibrated on the input image
or, with --all, on the first 8 images of --img_dir; the head stays float.

Weights: --weights (an npz of torch-layout weights, or a reference
PyTorch .pt, see utils/torch_import.py) wins over
--checkpoint (a .pt of the port's train CLI, whose EMA weights are used,
or a bare state dict); with neither, a random init from a seed. The model
runs with bf16 activations, with BatchNorm folded under --fuse.

Usage (on a machine with a CUDA card):
  python -m yolov5m_tpu_torch.cli.detect --weights w.npz --nc 80 \\
      --img_dir images/val --all --bs 16 --save_pred
"""

from __future__ import annotations

import argparse
import json
import os
import random
import time

import numpy as np
import torch

from yolov5m_tpu_torch.data.dataset import IMAGE_EXTS
from yolov5m_tpu_torch.utils.checkpoint import with_ema

# the activations' dtype (weights stay f32), the JAX CLI's policy
COMPUTE_DTYPE = torch.bfloat16


def arg_parser(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", type=str, default=None,
                   help="a .pt of the port's train CLI (EMA weights used), "
                        "or a bare state dict")
    p.add_argument("--weights", type=str, default=None,
                   help="npz of torch-layout weights, or a reference .pt "
                        "state dict (wins over --checkpoint)")
    p.add_argument("--img", type=str, default=None)
    p.add_argument("--img_dir", type=str, default=None,
                   help="pick a random image from this directory when --img "
                        "is not given")
    p.add_argument("--nc", type=int, default=2, help="number of classes (FLIR=2)")
    p.add_argument("--labels", type=str, default=None,
                   help="comma-separated class names; default FLIR or COCO by nc")
    p.add_argument("--first_out", type=int, default=None,
                   help="width override (default: from --model)")
    p.add_argument("--model", type=str, default="m",
                   choices=["n", "s", "m", "l", "x"])
    p.add_argument("--image_size", type=int, default=640)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--save_pred", action="store_true",
                   help="save annotated images (and, with --all, "
                        "detections.json) under --out")
    p.add_argument("--fuse", action="store_true",
                   help="fold BatchNorm into the convs")
    p.add_argument("--int8", action="store_true",
                   help="post-training int8 quantization (implies --fuse; "
                        "calibrates on the input image, or with --all on "
                        "the first 8 images; models/quantize.py)")
    p.add_argument("--all", action="store_true",
                   help="with --img_dir: every image, in batches of --bs")
    p.add_argument("--bs", type=int, default=16,
                   help="batch size for --all")
    p.add_argument("--anchors", type=str, default=None,
                   help="anchors.json of an --autoanchor training run")
    p.add_argument("--out", type=str, default="detections_exp")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def list_images(img_dir: str):
    """Sorted image file names in img_dir."""
    return sorted(f for f in os.listdir(img_dir)
                  if f.lower().endswith(IMAGE_EXTS))


def load_state_dict(opt, model) -> dict:
    """The weights the flags name, as a state dict of ``model``'s keys."""
    if opt.weights and opt.weights.endswith(".pt"):
        from yolov5m_tpu_torch.utils.torch_import import load_torch_state_dict
        return {k: torch.from_numpy(v)
                for k, v in load_torch_state_dict(opt.weights).items()}
    if opt.weights:
        with np.load(opt.weights) as z:
            return {k: torch.from_numpy(z[k]).float() for k in z.files}
    if opt.checkpoint:
        state = torch.load(opt.checkpoint, map_location="cpu",
                           weights_only=True)
        if isinstance(state, dict) and "model" in state and "ema" in state:
            try:
                return with_ema(state, model)
            except ValueError as e:
                raise SystemExit(f"{opt.checkpoint}: its EMA does not fit "
                                 f"this model (--model/--first_out/--nc): "
                                 f"{e}") from None
        if isinstance(state, dict) and all(isinstance(v, torch.Tensor)
                                           for v in state.values()):
            return state
        raise SystemExit(f"{opt.checkpoint}: unrecognized checkpoint "
                         "structure")
    print("WARNING: no --checkpoint/--weights given; using random init")
    return model.state_dict()


def build_model(opt, nc: int, device):
    """(model on the device, in eval mode, config) for the flags."""
    from yolov5m_tpu_torch.config import Config
    from yolov5m_tpu_torch.models.fuse import fold_batchnorm
    from yolov5m_tpu_torch.models.yolo import FAMILY, YOLOv5

    fam_fo, fam_dm = FAMILY[opt.model]
    first_out = opt.first_out if opt.first_out is not None else fam_fo
    cfg = Config(first_out=first_out, nc=nc, image_size=opt.image_size)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)              # the random init, from a seed
        model = YOLOv5(first_out=first_out, nc=nc, depth_mult=fam_dm,
                       compute_dtype=COMPUTE_DTYPE)
    sd = load_state_dict(opt, model)
    if opt.fuse:
        sd = fold_batchnorm(sd)
        model = YOLOv5(first_out=first_out, nc=nc, depth_mult=fam_dm,
                       fused=True, compute_dtype=COMPUTE_DTYPE)
    model.load_state_dict(sd, strict=True)
    model = model.to(device=device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model.eval(), cfg


def main(opt, nms_backend: str = "auto"):
    """Run the CLI. Returns the results dict of --all (image name -> list
    of detections), else None. nms_backend: fused_detect's dispatch ("auto"
    runs the CUDA kernel on the card, "torch" the plain version)."""
    from yolov5m_tpu_torch.config import COCO_LABELS, FLIR_LABELS, require_device
    from yolov5m_tpu_torch.models.yolo import normalized_anchors

    if opt.all and not opt.img_dir:
        raise SystemExit("--all needs --img_dir")
    if not opt.img and not opt.img_dir:
        raise SystemExit("give --img or --img_dir")
    labels = (opt.labels.split(",") if opt.labels
              else list(FLIR_LABELS if opt.nc == 2 else COCO_LABELS))
    if opt.save_pred:
        # a class name the images cannot draw stops the run before any work
        from yolov5m_tpu_torch.utils.plotting import check_labels
        check_labels(labels)
    device = require_device(opt.device)
    model, cfg = build_model(opt, opt.nc, device)
    if opt.anchors:
        with open(opt.anchors) as f:
            anchors_norm = normalized_anchors(
                anchors=np.asarray(json.load(f), np.float32))
        print(f"==> using anchors from {opt.anchors}")
    else:
        anchors_norm = normalized_anchors()
    anchors = torch.from_numpy(anchors_norm).to(device)

    if opt.all:
        if opt.int8:
            model = _quantize_on_dir(opt, model, device)
        return _detect_dir(opt, model, anchors, cfg, labels, device,
                           nms_backend)
    _detect_one(opt, model, anchors, cfg, labels, device, nms_backend)
    return None


@torch.no_grad()
def _infer(model, anchors, cfg, opt, x_u8: torch.Tensor, nms_backend: str):
    """uint8 (bs, S, S, 3) on the device -> (det, valid) on the host."""
    from yolov5m_tpu_torch.ops.postprocess import fused_detect
    from yolov5m_tpu_torch.ops.preprocess import normalize_uint8

    preds = model(normalize_uint8(x_u8, model.compute_dtype))
    det, valid = fused_detect(preds, anchors, conf_threshold=opt.conf,
                              iou_threshold=opt.iou,
                              max_detections=cfg.max_detections,
                              pre_nms_topk=cfg.topk_for_conf(opt.conf),
                              backend=nms_backend)
    return det.cpu().numpy(), valid.cpu().numpy()


def _detect_one(opt, model, anchors, cfg, labels, device, nms_backend):
    """One image: detections printed in source-image pixels, and with
    --save_pred the annotated image. The image is read as the JAX CLI's
    Image.open(...).convert("RGB") reads it (load_image_pillow: a JPEG as
    Pillow's libjpeg-turbo 3.1.3 decodes it), --all's as its loader does."""
    from yolov5m_tpu_torch.data.native import letterbox, load_image_pillow
    from yolov5m_tpu_torch.ops.boxes import unletterbox_boxes_np

    img_path = opt.img
    if img_path is None:
        candidates = list_images(opt.img_dir)
        if not candidates:
            raise SystemExit(f"no images in {opt.img_dir}")
        img_path = os.path.join(opt.img_dir, random.choice(candidates))
        print(f"random image: {img_path}")
    raw = load_image_pillow(img_path)
    img, ratio, dwdh = letterbox(raw, (opt.image_size, opt.image_size))
    if opt.int8:
        model = _quantize(model, [img], device)
        print("==> int8 PTQ (calibrated on the input image)")
    t0 = time.perf_counter()
    det, valid = _infer(model, anchors, cfg, opt,
                        torch.from_numpy(img[None]).to(device), nms_backend)
    print(f"inference (incl. warmup): {time.perf_counter() - t0:.2f}s")
    rows = det[0][valid[0]].copy()
    if len(rows):
        rows[:, 2:6] = unletterbox_boxes_np(rows[:, 2:6], ratio, dwdh,
                                            raw.shape[:2])
    print(f"{len(rows)} detections (original-image coords, "
          f"{raw.shape[1]}x{raw.shape[0]}):")
    for r in rows:
        name = labels[int(r[0])] if int(r[0]) < len(labels) else str(int(r[0]))
        print(f"  {name:>14s} {r[1]:.3f} [{r[2]:.0f}, {r[3]:.0f}, "
              f"{r[4]:.0f}, {r[5]:.0f}]")
    if opt.save_pred:
        from yolov5m_tpu_torch.utils.plotting import plot_image
        os.makedirs(opt.out, exist_ok=True)
        out_path = os.path.join(
            opt.out, os.path.splitext(os.path.basename(img_path))[0] + "_pred.png")
        plot_image(raw.astype(np.float32) / 255.0, rows, labels,
                   save_path=out_path)
        print(f"saved {out_path}")


def _quantize(model, imgs, device):
    """The int8 chain model of ``model``, calibrated on the letterboxed
    uint8 images ``imgs`` as one batch, in the model's input domain (/255
    in f32, as the JAX CLI divides)."""
    from yolov5m_tpu_torch.models.quantize import quantize_int8

    calib = torch.from_numpy(np.stack(imgs).astype(np.float32) / 255.0)
    qmodel, _ = quantize_int8(model, model.state_dict(), [calib.to(device)])
    return qmodel


def _quantize_on_dir(opt, model, device):
    """int8 PTQ for --all: calibrate on the first 8 images of --img_dir."""
    from yolov5m_tpu_torch.data.native import letterbox, load_image_rgb

    imgs = [letterbox(load_image_rgb(os.path.join(opt.img_dir, name)),
                      (opt.image_size, opt.image_size))[0]
            for name in list_images(opt.img_dir)[:8]]
    if not imgs:
        raise SystemExit(f"no images in {opt.img_dir}")
    model = _quantize(model, imgs, device)
    print(f"==> int8 PTQ (calibrated on {len(imgs)} images)")
    return model


def _detect_dir(opt, model, anchors, cfg, labels, device,
                nms_backend: str = "auto") -> dict:
    """Every image of --img_dir: letterboxed on the host into uint8
    batches of --bs (a short last batch padded with 114), one forward and
    one fused_detect per batch, detections mapped back to each source
    image. Returns {name: [{"class", "conf", "box_xyxy"}, ...]}; with
    --save_pred also writes the annotated images and detections.json."""
    from yolov5m_tpu_torch.data.loaders import to_device
    from yolov5m_tpu_torch.data.native import letterbox, load_image_rgb
    from yolov5m_tpu_torch.ops.boxes import unletterbox_boxes_np

    names = list_images(opt.img_dir)
    if not names:
        raise SystemExit(f"no images in {opt.img_dir}")
    bs = max(1, opt.bs)
    size = opt.image_size
    if opt.save_pred:
        from yolov5m_tpu_torch.utils.plotting import plot_image
        os.makedirs(opt.out, exist_ok=True)
    all_results = {}
    t0 = time.perf_counter()
    for start in range(0, len(names), bs):
        chunk = names[start:start + bs]
        raws, geoms = [], []
        batch = np.full((bs, size, size, 3), 114, np.uint8)
        for j, name in enumerate(chunk):
            raw = load_image_rgb(os.path.join(opt.img_dir, name))
            img, ratio, dwdh = letterbox(raw, (size, size))
            batch[j] = img
            raws.append(raw)
            geoms.append((ratio, dwdh))
        det, valid = _infer(model, anchors, cfg, opt,
                            to_device(batch, device), nms_backend)
        for j, name in enumerate(chunk):
            rows = det[j][valid[j]].copy()
            ratio, dwdh = geoms[j]
            if len(rows):
                rows[:, 2:6] = unletterbox_boxes_np(rows[:, 2:6], ratio, dwdh,
                                                    raws[j].shape[:2])
            all_results[name] = [
                {"class": labels[int(r[0])] if int(r[0]) < len(labels)
                 else str(int(r[0])),
                 "conf": float(r[1]),
                 "box_xyxy": [float(v) for v in r[2:6]]} for r in rows]
            print(f"{name}: {len(rows)} detections")
            if opt.save_pred:
                plot_image(raws[j].astype(np.float32) / 255.0, rows, labels,
                           save_path=os.path.join(
                               opt.out,
                               os.path.splitext(name)[0] + "_pred.png"))
    dt = time.perf_counter() - t0
    print(f"{len(names)} images in {dt:.2f}s ({len(names) / dt:.1f} img/s "
          f"incl. host decode)")
    if opt.save_pred:
        with open(os.path.join(opt.out, "detections.json"), "w") as f:
            json.dump(all_results, f, indent=1)
        print(f"saved {opt.out}/detections.json")
    return all_results


def cli():
    """Console-script entry point."""
    main(arg_parser())


if __name__ == "__main__":
    cli()
