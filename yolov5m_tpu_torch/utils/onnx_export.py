"""ONNX export of the YOLOv5 graph, without torch.onnx or the onnx package.

Port of ``yolov5m_tpu/utils/onnx_export.py``, fed the port's state dict
(the reference torch-layout keys of ``models/weights.py``). It walks the
topology of models/yolo.py (backbone taps at 4/6, FPN-up and PAN-down
neck, anchor-major head reshape) and emits an opset-11 NCHW graph: Conv
with bias (BatchNorm is folded first by ``models/fuse.py``), SiLU as
Sigmoid and Mul, MaxPool, Concat, Resize (nearest, 2x), Add, Reshape,
Transpose. Input "images": (bs, 3, H, W) f32 in [0, 1]. Outputs
"p3"/"p4"/"p5": (bs, 3, H/S, W/S, 5+nc) raw logits, the model's outputs.

Nodes and initializers carry the names the JAX exporter gives them (the
flax module path joined by "_"), and the fold is bit-equal to JAX's, so
the file is byte-equal to the JAX package's on the same weights.
(``torch.onnx.export`` needs the onnx package, which this port does not
assume.)
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from yolov5m_tpu_torch.models.fuse import fold_batchnorm
from yolov5m_tpu_torch.models.weights import torch_key_for_path
from yolov5m_tpu_torch.models.yolo import _scaled_depth
from yolov5m_tpu_torch.utils import onnx_proto as op


class _GraphBuilder:
    def __init__(self, state_dict):
        self.sd = state_dict         # torch-layout keys, OIHW f32 arrays
        self.nodes = []
        self.inits = []
        self.n = 0

    def uniq(self, stem: str) -> str:
        self.n += 1
        return f"{stem}_{self.n}"

    def const(self, name: str, arr: np.ndarray) -> str:
        self.inits.append(op.tensor(name, arr))
        return name

    def param(self, path) -> np.ndarray:
        """The f32 weight of a flax variable path, read by its torch key."""
        return np.asarray(self.sd[torch_key_for_path("params", path)],
                          np.float32)

    def conv(self, prefix: str, x: str, stride: int, pad: int) -> str:
        """CBL conv (BN already folded into weight+bias) + SiLU."""
        w = self.param(prefix + ("conv", "kernel"))         # OIHW
        bias = self.param(prefix + ("conv", "bias"))
        name = "_".join(prefix)
        wn = self.const(name + "_w", w)
        bn = self.const(name + "_b", bias)
        y = self.uniq(name)
        self.nodes.append(op.node(
            "Conv", [x, wn, bn], [y], name=name,
            attrs=[op.attr_ints("kernel_shape", w.shape[2:]),
                   op.attr_ints("strides", [stride, stride]),
                   op.attr_ints("pads", [pad, pad, pad, pad])]))
        return self.silu(y)

    def head_conv(self, prefix: str, x: str) -> str:
        """1x1 head conv, bias, NO activation."""
        w = self.param(prefix + ("kernel",))
        bias = self.param(prefix + ("bias",))
        name = "_".join(prefix)
        wn = self.const(name + "_w", w)
        bn = self.const(name + "_b", bias)
        y = self.uniq(name)
        self.nodes.append(op.node(
            "Conv", [x, wn, bn], [y], name=name,
            attrs=[op.attr_ints("kernel_shape", [1, 1]),
                   op.attr_ints("strides", [1, 1]),
                   op.attr_ints("pads", [0, 0, 0, 0])]))
        return y

    def silu(self, x: str) -> str:
        s = self.uniq("sig")
        y = self.uniq("silu")
        self.nodes.append(op.node("Sigmoid", [x], [s]))
        self.nodes.append(op.node("Mul", [x, s], [y]))
        return y

    def add(self, a: str, b: str) -> str:
        y = self.uniq("add")
        self.nodes.append(op.node("Add", [a, b], [y]))
        return y

    def concat(self, xs: Sequence[str]) -> str:
        y = self.uniq("cat")
        self.nodes.append(op.node("Concat", list(xs), [y],
                                  attrs=[op.attr_int("axis", 1)]))
        return y

    def maxpool5(self, x: str) -> str:
        y = self.uniq("pool")
        self.nodes.append(op.node(
            "MaxPool", [x], [y],
            attrs=[op.attr_ints("kernel_shape", [5, 5]),
                   op.attr_ints("strides", [1, 1]),
                   op.attr_ints("pads", [2, 2, 2, 2])]))
        return y

    def upsample2x(self, x: str) -> str:
        """Resize nearest, scales (1,1,2,2) — opset 11: inputs X, roi, scales."""
        roi = self.const(self.uniq("roi"), np.zeros((0,), np.float32))
        sc = self.const(self.uniq("scales"),
                        np.asarray([1, 1, 2, 2], np.float32))
        y = self.uniq("up")
        self.nodes.append(op.node(
            "Resize", [x, roi, sc], [y],
            attrs=[op.attr_string("mode", "nearest"),
                   op.attr_string("coordinate_transformation_mode",
                                  "asymmetric"),
                   op.attr_string("nearest_mode", "floor")]))
        return y

    # -------- composite blocks (same wiring as models/blocks.py) --------

    def cbl(self, prefix, x, k, s, pd):
        # k is VALIDATION, not control: kernel_shape comes from the weight
        # array, so a k that disagrees with the variables is a wiring bug
        # that would otherwise export a silently-wrong graph
        kern = self.param(prefix + ("conv", "kernel"))
        if kern.shape[2] != k:
            raise ValueError(
                f"{'/'.join(prefix)}: weight kernel {kern.shape} vs expected "
                f"k={k}: the weights do not match the architecture emitted")
        return self.conv(prefix, x, s, pd)

    def bottleneck(self, prefix, x):
        y = self.cbl(prefix + ("c1",), x, 1, 1, 0)
        y = self.cbl(prefix + ("c2",), y, 3, 1, 1)
        return self.add(y, x)

    def c3(self, prefix, x, depth, backbone):
        y = self.cbl(prefix + ("c1",), x, 1, 1, 0)
        for j in range(depth):
            if backbone:
                y = self.bottleneck(prefix + (f"seq{j}",), y)
            else:
                y = self.cbl(prefix + (f"seq{j}_a",), y, 1, 1, 0)
                y = self.cbl(prefix + (f"seq{j}_b",), y, 3, 1, 1)
        skip = self.cbl(prefix + ("c_skipped",), x, 1, 1, 0)
        return self.cbl(prefix + ("c_out",), self.concat([y, skip]), 1, 1, 0)

    def sppf(self, prefix, x):
        x = self.cbl(prefix + ("c1",), x, 1, 1, 0)
        p1 = self.maxpool5(x)
        p2 = self.maxpool5(p1)
        p3 = self.maxpool5(p2)
        return self.cbl(prefix + ("c_out",), self.concat([x, p1, p2, p3]),
                        1, 1, 0)

    def head_reshape(self, x: str, out_name: str, bs, na, no, ny, nx):
        """(bs, na*no, ny, nx) -> Reshape (bs,na,no,ny,nx) -> Transpose
        (0,1,3,4,2) -> (bs, na, ny, nx, no) — anchor-major like the flax head
        (models/yolo.py:47) and the reference view+permute (model.py:170-173)."""
        shp = self.const(self.uniq("shape"),
                         np.asarray([bs, na, no, ny, nx], np.int64))
        r = self.uniq("resh")
        self.nodes.append(op.node("Reshape", [x, shp], [r]))
        self.nodes.append(op.node(
            "Transpose", [r], [out_name],
            attrs=[op.attr_ints("perm", [0, 1, 3, 4, 2])]))
        return out_name


def export_onnx(state_dict: Dict[str, torch.Tensor], path: str, nc: int = 80,
                first_out: int = 48, image_size: int = 640, batch: int = 1,
                na: int = 3, depth_mult: float = 0.67) -> str:
    """Serialize the YOLOv5 forward as a literal opset-11 .onnx file.

    state_dict: the model's weights, torch-layout keys, unfused (BN is
    folded here) or already folded. Returns the path. depth_mult follows
    the family law in models/yolo.py (0.67 = YOLOv5m).
    """
    sd = {k: torch.as_tensor(v).float() for k, v in state_dict.items()}
    if any(".cbl.1." in k for k in sd):
        sd = fold_batchnorm(sd)
    sd = {k: v.cpu().numpy() for k, v in sd.items()}
    # first_out is a check (the widths come from the weights): a mismatch
    # means the caller is exporting another model
    stem = sd[torch_key_for_path("params", ("backbone_0", "conv", "kernel"))]
    if stem.shape[0] != first_out:
        raise ValueError(f"the weights have first_out={stem.shape[0]} but "
                         f"the caller passed {first_out}")
    g = _GraphBuilder(sd)

    x = "images"
    no = 5 + nc
    d3, d6, d9 = (_scaled_depth(b, depth_mult) for b in (3, 6, 9))
    depths = {2: d3, 4: d6, 6: d9, 8: d3}

    # backbone (models/yolo.py:72-83): stem 6x6/s2/p2, alternating CBL-s2/C3
    taps = []
    x = g.cbl(("backbone_0",), x, 6, 2, 2)
    for idx in range(1, 9):
        p = (f"backbone_{idx}",)
        if idx % 2 == 1:
            x = g.cbl(p, x, 3, 2, 1)
        else:
            x = g.c3(p, x, depths[idx], True)
        if idx in (4, 6):
            taps.append(x)
    x = g.sppf(("backbone_9",), x)

    # neck (models/yolo.py:85-129)
    feats, stash = [], []
    for idx in range(8):
        p = (f"neck_{idx}",)
        if idx in (0, 2):
            x = g.cbl(p, x, 1, 1, 0)
            stash.append(x)
            x = g.upsample2x(x)
            x = g.concat([x, taps.pop()])
        elif idx in (4, 6):
            x = g.cbl(p, x, 3, 2, 1)
            x = g.concat([x, stash.pop()])
        else:
            x = g.c3(p, x, d3, False)
            if idx > 2:
                feats.append(x)

    # head
    outputs = []
    out_infos = []
    for i, f in enumerate(feats):
        stride = 8 * (2 ** i)
        ny = nx = image_size // stride
        y = g.head_conv(("head", f"out_conv{i}"), f)
        name = f"p{i + 3}"
        g.head_reshape(y, name, batch, na, no, ny, nx)
        outputs.append(name)
        out_infos.append(op.value_info(name, [batch, na, ny, nx, no]))

    graph_msg = op.graph(
        nodes=g.nodes,
        name="yolov5_tpu",
        initializers=g.inits,
        inputs=[op.value_info("images", [batch, 3, image_size, image_size])],
        outputs=out_infos,
    )
    blob = op.model(graph_msg, opset=11)
    with open(path, "wb") as f:
        f.write(blob)
    return path
