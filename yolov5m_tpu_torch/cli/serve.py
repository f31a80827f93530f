"""Serving CLI: run the batching detection server (serving/server.py).

Port of ``yolov5m_tpu/cli/serve.py``. Weights come from ``--weights``,
an npz of torch-layout weights (reference state-dict keys) or a reference
.pt, which wins over ``--checkpoint``, a .pt of the port's train CLI (its
EMA weights), as in cli/detect.py. With neither, the committed flagship
blob serves when the model has its shape (nc 80, first_out 48, depth
0.67); any other shape serves a random init from a seed, with the JAX
CLI's warning. (``--nc`` defaults to 80 here, to 2 in the JAX CLI.)
BatchNorm is folded unless ``--no_fuse``. The model runs in bf16 with
channels_last memory. ``--dp N`` serves each batch over N devices, one
replica and one shard a device (0: one device). ``--tp N`` splits every
layer's output channels over N devices (``parallel/tp.py``); with it
``--dp`` is the number of rows of the (data, model) grid, each row taking
its share of the batch.

Usage:
  python -m yolov5m_tpu_torch.cli.serve --nc 80 --port 5005 --bs 128
  python -m yolov5m_tpu_torch.cli.serve --nc 80 --dp 4 --bs 512
  python -m yolov5m_tpu_torch.cli.serve --nc 80 --tp 2 --dp 2 --bs 256

  # client side:
  #   from yolov5m_tpu_torch.serving.server import DetectionClient
  #   with DetectionClient(port=5005) as c:
  #       print(c.detect(open("img.ppm", "rb").read()))
"""

from __future__ import annotations

import argparse
import json
import threading

import numpy as np
import torch


def arg_parser(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", type=str, default=None,
                   help="a .pt of the port's train CLI (EMA weights used), "
                        "or a bare state dict")
    p.add_argument("--weights", type=str, default=None,
                   help="npz of torch-layout weights or a reference .pt "
                        "(wins over --checkpoint); default: the flagship "
                        "blob in weights/ where the model has its shape, "
                        "else a random init")
    p.add_argument("--nc", type=int, default=80)
    p.add_argument("--labels", type=str, default=None,
                   help="comma-separated class names; default FLIR/COCO by nc")
    p.add_argument("--model", type=str, default="m",
                   choices=["n", "s", "m", "l", "x"])
    p.add_argument("--first_out", type=int, default=None)
    p.add_argument("--image_size", type=int, default=640)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--bs", type=int, default=128, help="device batch")
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="max batching delay after the first queued request")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=5005)
    p.add_argument("--no_fuse", action="store_true",
                   help="keep live BatchNorm (debugging only)")
    p.add_argument("--no_overlap", action="store_true",
                   help="disable depth-1 batch pipelining (debugging only)")
    p.add_argument("--anchors", type=str, default=None,
                   help="anchors.json from an --autoanchor run")
    p.add_argument("--dp", type=int, default=0,
                   help="serve the batch data-parallel over N devices (0 = "
                        "one device); --bs must be a multiple of N, e.g. "
                        "128 * N")
    p.add_argument("--tp", type=int, default=1,
                   help="split the channels over N devices (with --dp: a "
                        "dp x tp grid, --bs a multiple of dp)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


# (nc, first_out, depth_mult) of the committed flagship weights
FLAGSHIP_SHAPE = (80, 48, 0.67)


def build_server(opt):
    """The DetectionServer the flags describe (not started)."""
    from yolov5m_tpu_torch.config import (COCO_LABELS, FLIR_LABELS, Config,
                                          require_device)
    from yolov5m_tpu_torch.models.fuse import fold_batchnorm
    from yolov5m_tpu_torch.models.weights import load_flagship
    from yolov5m_tpu_torch.models.yolo import (FAMILY, YOLOv5,
                                               normalized_anchors)
    from yolov5m_tpu_torch.cli.detect import load_state_dict
    from yolov5m_tpu_torch.parallel.dp import make_mesh
    from yolov5m_tpu_torch.serving.server import DetectionServer

    device = require_device(opt.device)
    dp_devices = tp_devices = None
    if opt.tp > 1:
        from yolov5m_tpu_torch.parallel.mesh import make_tp_mesh
        n_data = max(opt.dp, 1)
        try:
            mesh = make_tp_mesh(n_data, opt.tp, device=device.type)
        except ValueError as e:
            raise SystemExit(f"--tp {opt.tp} x --dp {n_data}: {e}")
        if opt.bs % n_data:
            raise SystemExit(f"--bs {opt.bs} must be a multiple of --dp "
                             f"{n_data}")
        tp_devices = mesh.devices.tolist()
        device = mesh.devices.flat[0]
    elif opt.dp > 1:
        try:
            dp_devices = make_mesh(opt.dp, device.type)
        except ValueError as e:
            raise SystemExit(f"--dp {opt.dp}: {e}")
        if opt.bs % opt.dp:
            raise SystemExit(f"--bs {opt.bs} must be a multiple of --dp "
                             f"{opt.dp}")
        device = dp_devices[0]
    labels = (opt.labels.split(",") if opt.labels
              else FLIR_LABELS if opt.nc == 2 else COCO_LABELS)
    fam_fo, fam_dm = FAMILY[opt.model]
    first_out = opt.first_out if opt.first_out is not None else fam_fo
    cfg = Config(first_out=first_out, nc=opt.nc, image_size=opt.image_size)
    flagship_fits = (cfg.nc, cfg.first_out, fam_dm) == FLAGSHIP_SHAPE
    if opt.weights or opt.checkpoint or not flagship_fits:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)              # the random init, from a seed
            template = YOLOv5(first_out=cfg.first_out, nc=cfg.nc,
                              depth_mult=fam_dm)
        sd = load_state_dict(opt, template)   # warns for the random init
        if not opt.no_fuse:
            sd = fold_batchnorm(sd)
    else:
        sd, _ = load_flagship(fold=not opt.no_fuse, device="cpu")
    model = YOLOv5(first_out=cfg.first_out, nc=cfg.nc, depth_mult=fam_dm,
                   fused=not opt.no_fuse)
    model.load_state_dict(sd, strict=True)
    model = model.to(device=device, dtype=torch.bfloat16,
                     memory_format=torch.channels_last).eval()
    if opt.anchors:
        with open(opt.anchors) as f:
            anchors = normalized_anchors(
                anchors=np.asarray(json.load(f), np.float32))
    else:
        anchors = normalized_anchors()
    return DetectionServer(
        model, anchors, labels=labels, image_size=opt.image_size,
        conf_threshold=opt.conf, iou_threshold=opt.iou,
        max_detections=cfg.max_detections, batch_size=opt.bs,
        max_wait_ms=opt.max_wait_ms, overlap=not opt.no_overlap,
        dp_devices=dp_devices, tp_devices=tp_devices, host=opt.host,
        port=opt.port)


def main(opt):
    server = build_server(opt)
    if opt.tp > 1:
        print(f"==> tensor-parallel serving over a {max(opt.dp, 1)}x{opt.tp} "
              "(data, model) grid", flush=True)
    elif opt.dp > 1:
        print(f"==> data-parallel serving over {opt.dp} devices", flush=True)
    print(f"==> warming up the bs={opt.bs} pipeline ...", flush=True)
    server.start()
    print(f"==> serving on {opt.host}:{server.port} "
          f"(bs={opt.bs}, conf={opt.conf}, iou={opt.iou})", flush=True)
    try:
        threading.Event().wait()  # serve until interrupted
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


def cli():
    """Console-script entry point."""
    main(arg_parser())


if __name__ == "__main__":
    cli()
