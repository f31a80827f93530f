"""Post-training int8 quantization (PTQ) for inference.

Port of ``yolov5m_tpu/models/quantize.py``, on torch-layout state dicts:

  1. fold BatchNorm (``models/fuse.py``): PTQ works on the fused graph;
  2. calibrate: run the fused model over a few batches and keep, per CBL,
     the max over batches of its input's and its output's absolute max,
     and per Bottleneck that of its residual sum;
  3. quantize: weights per-output-channel symmetric int8
     (s_w = absmax(w) / 127 per channel), activations per-tensor symmetric
     int8 against the calibrated scales (s = absmax / 127).

The head's 1x1 output convs stay float; every CBL conv runs int8
(``models/blocks.py``). The arithmetic is the JAX package's, in its order:
weight scales in f32, activation scales in double rounded to f32, weights
quantized on the host.

Calibration keys are module paths with the JAX leaf names, e.g.
``"backbone.0.in_absmax"``, ``"backbone.2.seq.0.res_absmax"``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch
from torch import nn

from yolov5m_tpu_torch.models.blocks import CBL, Bottleneck
from yolov5m_tpu_torch.models.fuse import fold_batchnorm

CONV_WEIGHT = ".cbl.0.weight"
CONV_BIAS = ".cbl.0.bias"
# the floor of every scale, as in JAX
SCALE_FLOOR = 1e-12


def _absmax(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().abs().amax()


@torch.no_grad()
def collect_calibration_absmax(fused_model: nn.Module,
                               batches: Iterable) -> Dict[str, float]:
    """Run the fused float model over calibration batches (NHWC float, in
    the model's input domain, i.e. /255); return per-CBL ``in_absmax`` and
    ``out_absmax`` and per-Bottleneck ``res_absmax``, each the max over
    batches, keyed by module path. The values are read by forward hooks:
    a CBL's input and its SiLU output, a Bottleneck's sum, each in the
    compute dtype as the JAX package sows them."""
    if not getattr(fused_model, "fused", False) or fused_model.quant:
        raise ValueError("calibration runs on the fused float model")
    device = fused_model.head.out_convs[0].weight.device
    seen: Dict[str, torch.Tensor] = {}

    def record(key: str, value: torch.Tensor) -> None:
        seen[key] = value if key not in seen else torch.maximum(seen[key], value)

    def cbl_hook(name):
        def hook(module, args, out):
            record(f"{name}.in_absmax", _absmax(args[0]))
            record(f"{name}.out_absmax", _absmax(out))
        return hook

    def res_hook(name):
        def hook(module, args, out):
            record(f"{name}.res_absmax", _absmax(out))
        return hook

    handles = []
    for name, m in fused_model.named_modules():
        if isinstance(m, CBL):
            handles.append(m.register_forward_hook(cbl_hook(name)))
        elif isinstance(m, Bottleneck):
            handles.append(m.register_forward_hook(res_hook(name)))
    was_training = fused_model.training
    fused_model.eval()
    try:
        for x in batches:
            fused_model(torch.as_tensor(x).to(device))
    finally:
        for h in handles:
            h.remove()
        fused_model.train(was_training)
    if not seen:
        raise ValueError("calibration saw no batch")
    return {k: float(v) for k, v in seen.items()}


def _scale(absmax: float) -> torch.Tensor:
    """A per-tensor activation scale: max(absmax, 1e-12) / 127 in double,
    then f32 (JAX: np.float32(max(am, 1e-12) / 127.0))."""
    return torch.tensor(max(absmax, SCALE_FLOOR) / 127.0, dtype=torch.float32)


def quantize_fused_params(fused_sd: Dict[str, torch.Tensor],
                          absmax: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """Fused state dict + calibration -> the per-block int8 state dict
    (``YOLOv5(fused=True, quant="block")``), on the host: each CBL conv
    becomes ``w_q`` (int8, OIHW), ``s_w``, ``bias`` and ``s_in``; the head
    convs copy through."""
    q = {}
    for key, value in fused_sd.items():
        if key.startswith("head."):
            q[key] = value.detach().cpu()
        elif key.endswith(CONV_WEIGHT):
            parent = key[:-len(CONV_WEIGHT)]
            w = value.detach().cpu().float()
            s_w = (w.abs().amax((1, 2, 3)) / 127.0).clamp_min(SCALE_FLOOR)
            q[parent + ".w_q"] = (w / s_w.view(-1, 1, 1, 1)).round().clamp(
                -127, 127).to(torch.int8)
            q[parent + ".s_w"] = s_w
            q[parent + ".bias"] = fused_sd[parent + CONV_BIAS].detach().cpu().float()
            am = absmax.get(parent + ".in_absmax")
            if am is None:
                raise ValueError(f"no calibration absmax for {parent}")
            q[parent + ".s_in"] = _scale(am)
        elif not key.endswith(CONV_BIAS):
            raise ValueError(f"{key}: not a fused state dict entry")
    return q


def quantize_chain_params(fused_sd: Dict[str, torch.Tensor],
                          absmax: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """Fused state dict + calibration -> the int8 activation-chain state
    dict (``quant="chain"``): ``quantize_fused_params``'s entries plus each
    CBL's output scale ``s_out`` and each Bottleneck's ``s_res``."""
    q = quantize_fused_params(fused_sd, absmax)
    for key, am in absmax.items():
        parent, leaf = key.rsplit(".", 1)
        if leaf == "out_absmax" and parent + ".s_in" in q:
            q[parent + ".s_out"] = _scale(am)
        elif leaf == "res_absmax":
            q[parent + ".s_res"] = _scale(am)
    missing = [k[:-len(".s_in")] for k in q if k.endswith(".s_in")
               and k[:-len(".s_in")] + ".s_out" not in q]
    if missing:
        raise ValueError(f"missing out_absmax calibration for {missing[:3]}")
    return q


def model_like(model: nn.Module, **overrides) -> nn.Module:
    """A new YOLOv5 of ``model``'s shape and dtype policy, with overrides."""
    kw = dict(first_out=model.first_out, nc=model.nc,
              depth_mult=model.depth_mult, fused=model.fused,
              compute_dtype=model.compute_dtype, stem_s2d=model.stem_s2d,
              quant=model.quant)
    kw.update(overrides)
    return type(model)(**kw)


def quantize_int8(model: nn.Module, state_dict: Dict[str, torch.Tensor],
                  calib_batches: Iterable, chain: bool = True
                  ) -> Tuple[nn.Module, Dict[str, torch.Tensor]]:
    """One-call PTQ: (model, its state dict, unfused or fused) -> (int8
    model in eval mode on the state dict's device, its state dict).

    calib_batches: NHWC float batches in the model's input domain (/255).
    chain (default): the int8 activation chain; False: per block (float
    between blocks)."""
    if any(".cbl.1." in k for k in state_dict):
        state_dict = fold_batchnorm(state_dict)
    device = next(iter(state_dict.values())).device
    fused = model_like(model, fused=True, quant=None)
    fused.load_state_dict(state_dict, strict=True)
    fused = _placed(fused, device)
    absmax = collect_calibration_absmax(fused, calib_batches)
    quantize = quantize_chain_params if chain else quantize_fused_params
    qsd = quantize(state_dict, absmax)
    qmodel = model_like(model, fused=True, quant="chain" if chain else "block")
    qmodel.load_state_dict(qsd, strict=True)
    return _placed(qmodel, device), qsd


def _placed(model: nn.Module, device) -> nn.Module:
    model = model.to(device=device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model.eval()
