"""Data-parallel batch inference (serving) over a list of devices.

Port of ``yolov5m_tpu/parallel/infer.py``. The JAX package shard_maps the
fused pipeline over a 1-D mesh; the port holds one replica of the
(BN-folded) model per entry of a device list and runs each batch shard
through normalize -> model -> ``fused_detect`` (its NMS the CUDA kernel on
the card) on that device's own stream. Detection is batch-parallel: no
collectives. A list may name one card more than once; its replicas then
share the card, each on its own stream.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, Sequence

import torch

from yolov5m_tpu_torch.ops.postprocess import fused_detect
from yolov5m_tpu_torch.ops.preprocess import normalize_uint8


def make_dp_infer_fn(model: torch.nn.Module, anchors_norm,
                     devices: Sequence, conf_threshold: float = 0.25,
                     iou_threshold: float = 0.45,
                     max_detections: int = 300,
                     pre_nms_topk: int = 1024) -> Callable:
    """Build ``infer(images) -> (det, valid)`` over ``devices``.

    model: a fused (BN-folded) or plain YOLOv5; each device gets a copy in
    eval mode, channels_last on the card, in the model's dtype, which is
    also the dtype the uint8 frames are normalized to.
    images: (bs, H, W, 3) uint8 on the host or a device, bs a multiple of
    len(devices); device i takes rows [i*per, (i+1)*per).

    Returns (bs, max_detections, 6) [class, conf, x1 y1 x2 y2] and a (bs,
    max_detections) valid mask on the first device, in batch order."""
    devices = [torch.device(d) for d in devices]
    if not devices or len({d.type for d in devices}) != 1:
        raise ValueError(f"make_dp_infer_fn needs devices of one kind, got "
                         f"{devices}")
    dtype = next(model.parameters()).dtype
    replicas, streams, anchors = [], [], []
    for dev in devices:
        rep = copy.deepcopy(model).to(dev).eval()
        if dev.type == "cuda":
            rep = rep.to(memory_format=torch.channels_last)
            streams.append(torch.cuda.Stream(dev))
        else:
            streams.append(None)
        replicas.append(rep)
        anchors.append(torch.as_tensor(anchors_norm, dtype=torch.float32,
                                       device=dev))
    kw = dict(conf_threshold=conf_threshold, iou_threshold=iou_threshold,
              max_detections=max_detections, pre_nms_topk=pre_nms_topk)
    out_dev = devices[0]

    @torch.inference_mode()
    def infer(images: torch.Tensor):
        n = len(devices)
        if images.shape[0] % n:
            raise ValueError(f"batch {images.shape[0]} is not a multiple of "
                             f"the {n} devices")
        per = images.shape[0] // n
        outs = []
        for i, (rep, dev, st, anc) in enumerate(zip(replicas, devices,
                                                    streams, anchors)):
            shard = images[i * per:(i + 1) * per]
            ctx = contextlib.nullcontext()
            if st is not None:
                if shard.device == dev:
                    # written on the caller's stream, read on this one
                    st.wait_stream(torch.cuda.current_stream(dev))
                    shard.record_stream(st)
                ctx = torch.cuda.stream(st)
            with ctx:
                # a copy between devices synchronizes both current streams
                x = normalize_uint8(shard.to(dev, non_blocking=True), dtype)
                outs.append([t.to(out_dev, non_blocking=True) for t in
                             fused_detect(rep(x), anc, **kw)])
        if out_dev.type == "cuda":
            cur = torch.cuda.current_stream(out_dev)
            for st, dev, pair in zip(streams, devices, outs):
                cur.wait_stream(st)
                if dev == out_dev:         # made on st, read on cur
                    for t in pair:
                        t.record_stream(cur)
        return (torch.cat([d for d, _ in outs]),
                torch.cat([v for _, v in outs]))

    return infer
