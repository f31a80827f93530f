"""Model export CLI: port of ``yolov5m_tpu/cli/export.py``.

Writes a literal opset-11 ONNX file (``utils/onnx_export.py``) and/or a
``torch.export`` program (``utils/export.py``; JAX writes a StableHLO
artifact there), optionally with decode and NMS baked in. Weights load as
in cli/detect.py: --weights (an npz of torch-layout weights, or a
reference .pt) wins over --checkpoint (a .pt of the port's train CLI,
whose EMA weights are used, or a bare state dict, such as
``utils/checkpoint.py:strip_checkpoint`` writes); with neither, a random
init from a seed. The model is exported in f32, BatchNorm live (the ONNX
graph folds it).

Usage:
  python -m yolov5m_tpu_torch.cli.export --checkpoint ck.pt --nc 80 \\
      --onnx model.onnx --program model.pt2 --with_postprocess
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def arg_parser(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", type=str, default=None,
                   help="a .pt of the port's train CLI (EMA weights used), "
                        "or a bare state dict")
    p.add_argument("--weights", type=str, default=None,
                   help="npz of torch-layout weights, or a reference .pt "
                        "state dict (wins over --checkpoint)")
    p.add_argument("--nc", type=int, default=80)
    p.add_argument("--first_out", type=int, default=None,
                   help="width override (default: from --model)")
    p.add_argument("--model", type=str, default="m",
                   choices=["n", "s", "m", "l", "x"],
                   help="YOLOv5 family variant")
    p.add_argument("--image_size", type=int, default=640)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--onnx", type=str, default=None,
                   help="write a literal opset-11 .onnx here")
    p.add_argument("--program", type=str, default=None,
                   help="write a torch.export program (torch.export.save) "
                        "here")
    p.add_argument("--with_postprocess", action="store_true",
                   help="program only: bake decode+NMS into it")
    p.add_argument("--anchors", type=str, default=None,
                   help="anchors.json from an --autoanchor run, baked into "
                        "the postprocess export")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device the program is traced on, and runs on")
    return p.parse_args(argv)


def main(opt):
    from yolov5m_tpu_torch.cli.detect import load_state_dict
    from yolov5m_tpu_torch.config import require_device
    from yolov5m_tpu_torch.models.yolo import FAMILY, YOLOv5

    if not (opt.onnx or opt.program):
        raise SystemExit("give --onnx and/or --program output paths")
    device = require_device(opt.device)
    fam_fo, fam_dm = FAMILY[opt.model]
    first_out = opt.first_out if opt.first_out is not None else fam_fo
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)              # the random init, from a seed
        model = YOLOv5(first_out=first_out, nc=opt.nc, depth_mult=fam_dm)
    model.load_state_dict(load_state_dict(opt, model), strict=True)
    model = model.eval()

    if opt.onnx:
        from yolov5m_tpu_torch.utils.onnx_export import export_onnx
        path = export_onnx(model.state_dict(), opt.onnx, nc=opt.nc,
                           first_out=first_out, image_size=opt.image_size,
                           batch=opt.batch, depth_mult=fam_dm)
        print(f"wrote ONNX (opset 11): {path}")

    if opt.program:
        from yolov5m_tpu_torch.utils.export import export_program
        anchors_px = None
        if opt.anchors:
            with open(opt.anchors) as f:
                anchors_px = np.asarray(json.load(f), np.float32)
            print(f"==> baking anchors from {opt.anchors}")
        path = export_program(
            model.to(device), opt.program,
            input_shape=(opt.batch, opt.image_size, opt.image_size, 3),
            with_postprocess=opt.with_postprocess, anchors_px=anchors_px)
        print(f"wrote torch.export program: {path}")


def cli():
    """Console-script entry point."""
    main(arg_parser())


if __name__ == "__main__":
    cli()
