"""Weights for the port: the flax variable tree -> reference torch state dict.

Own copy of the name mapping in ``yolov5m_tpu/models/weights.py`` (the port
imports nothing of the JAX package), plus a small pure-Python msgpack
reader for the committed flagship blob, which is in flax's msgpack format:
a nested map of str keys whose leaves are ext type 1 records packing
``(shape, dtype name, raw bytes)``. Neither flax nor msgpack is needed.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import struct
from typing import Dict, Tuple

import numpy as np
import torch

from yolov5m_tpu_torch.config import require_device
from yolov5m_tpu_torch.models.fuse import fold_batchnorm


def _module_token_to_torch(token: str) -> str:
    """Map one flax module name to its torch path fragment."""
    m = re.fullmatch(r"(backbone|neck)_(\d+)", token)
    if m:
        return f"{m.group(1)}.{m.group(2)}"
    m = re.fullmatch(r"out_conv(\d+)", token)
    if m:
        return f"out_convs.{m.group(1)}"
    m = re.fullmatch(r"seq(\d+)_([ab])", token)
    if m:  # neck-mode C3 pair: torch nn.Sequential indices 0/1
        return f"seq.{m.group(1)}.{'0' if m.group(2) == 'a' else '1'}"
    m = re.fullmatch(r"seq(\d+)", token)
    if m:
        return f"seq.{m.group(1)}"
    return token  # c1, c2, c_skipped, c_out, head


# (collection, leaf-module, leaf-param) -> torch suffix inside a CBL. The
# conv bias exists only in BN-folded trees (models/fuse.py).
_CBL_LEAF = {
    ("params", "conv", "kernel"): "cbl.0.weight",
    ("params", "conv", "bias"): "cbl.0.bias",
    ("params", "bn", "scale"): "cbl.1.weight",
    ("params", "bn", "bias"): "cbl.1.bias",
    ("batch_stats", "bn", "mean"): "cbl.1.running_mean",
    ("batch_stats", "bn", "var"): "cbl.1.running_var",
}


def torch_key_for_path(collection: str, path: Tuple[str, ...]) -> str:
    """Translate a flax variable path to the reference torch state-dict key.

    e.g. ('backbone_2', 'seq0', 'c1', 'conv', 'kernel') ->
         'backbone.2.seq.0.c1.cbl.0.weight'
    """
    if len(path) >= 2 and path[0] == "head":
        torch_mods = [_module_token_to_torch(t) for t in path[:-1]]
        leaf = {"kernel": "weight", "bias": "bias"}[path[-1]]
        return ".".join(torch_mods + [leaf])

    leaf_key = _CBL_LEAF[(collection, path[-2], path[-1])]
    torch_mods = [_module_token_to_torch(t) for t in path[:-2]]
    return ".".join(torch_mods + [leaf_key])


def _to_torch(torch_key: str, value: np.ndarray) -> np.ndarray:
    if torch_key.endswith("weight") and value.ndim == 4:  # HWIO -> OIHW
        return np.transpose(value, (3, 2, 0, 1))
    return value


def _flatten(tree: dict, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_flax(variables_np: dict) -> Dict[str, np.ndarray]:
    """Nested dict of numpy arrays ({'params': ..., 'batch_stats': ...},
    or a BN-folded {'params': ...}) -> torch-layout state dict of f32
    numpy arrays: the keys and values of the JAX package's
    ``export_torch_state_dict`` (conv kernels HWIO -> OIHW)."""
    sd = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables_np.get(collection, {})):
            tkey = torch_key_for_path(collection, path)
            # a writable C-order copy, so torch.from_numpy may take it
            sd[tkey] = np.array(_to_torch(tkey, np.asarray(value)),
                                dtype=np.float32, order="C")
    return sd


# leaves of the JAX package's int8 tree (models/quantize.py) on a CBL or,
# s_res, on a Bottleneck; the port keeps each under the same name
INT8_LEAVES = ("w_q", "s_w", "bias", "s_in", "s_out", "s_res")


def state_dict_from_flax_int8(params_np: dict) -> Dict[str, np.ndarray]:
    """The JAX package's int8 parameter tree (``quantize_int8``'s
    ``{"params": ...}``, numpy leaves, per block or chain) -> the state dict
    of the port's ``YOLOv5(fused=True, quant=...)``: ``w_q`` HWIO -> OIHW
    int8, the scales and biases f32 under the module paths, the float head
    as ``state_dict_from_flax`` maps it."""
    sd = {}
    for path, value in _flatten(params_np.get("params", params_np)):
        value = np.asarray(value)
        if path[0] == "head":
            key = torch_key_for_path("params", path)
            sd[key] = np.array(_to_torch(key, value), dtype=np.float32,
                               order="C")
            continue
        if path[-1] not in INT8_LEAVES:
            raise ValueError(f"{'/'.join(path)}: not a leaf of an int8 tree")
        key = ".".join([_module_token_to_torch(t) for t in path[:-1]]
                       + [path[-1]])
        if path[-1] == "w_q":
            sd[key] = np.array(np.transpose(value, (3, 2, 0, 1)),
                               dtype=np.int8, order="C")
        else:
            sd[key] = np.array(value, dtype=np.float32, order="C")
    return sd


# -- msgpack ----------------------------------------------------------------

_EXT_NDARRAY = 1   # flax serialization's ext code for an ndarray


def _bf16_to_f32(raw: bytes) -> np.ndarray:
    """bf16 bit patterns -> f32 (exact: bf16 is the top half of an f32)."""
    return (np.frombuffer(raw, "<u2").astype(np.uint32) << 16).view(np.float32)


def _ndarray_from_ext(payload: bytes) -> np.ndarray:
    shape, dtype, raw = _Reader(payload).read()
    if dtype == "bfloat16":
        arr = _bf16_to_f32(raw)
    else:
        arr = np.frombuffer(raw, np.dtype(dtype)).copy()
    return arr.reshape(tuple(shape))


class _Reader:
    """Minimal msgpack decoder: map, array, str, bin, ext, int, float, nil
    and bool. Ext type 1 decodes to a numpy array (bf16 widened to f32)."""

    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0
        self._table = {
            0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
            0xC4: lambda: bytes(self._take(self._unpack(">B"))),
            0xC5: lambda: bytes(self._take(self._unpack(">H"))),
            0xC6: lambda: bytes(self._take(self._unpack(">I"))),
            0xC7: lambda: self._ext(self._unpack(">B")),
            0xC8: lambda: self._ext(self._unpack(">H")),
            0xC9: lambda: self._ext(self._unpack(">I")),
            0xCA: lambda: self._unpack(">f"),
            0xCB: lambda: self._unpack(">d"),
            0xCC: lambda: self._unpack(">B"),
            0xCD: lambda: self._unpack(">H"),
            0xCE: lambda: self._unpack(">I"),
            0xCF: lambda: self._unpack(">Q"),
            0xD0: lambda: self._unpack(">b"),
            0xD1: lambda: self._unpack(">h"),
            0xD2: lambda: self._unpack(">i"),
            0xD3: lambda: self._unpack(">q"),
            0xD4: lambda: self._ext(1),
            0xD5: lambda: self._ext(2),
            0xD6: lambda: self._ext(4),
            0xD7: lambda: self._ext(8),
            0xD8: lambda: self._ext(16),
            0xD9: lambda: str(self._take(self._unpack(">B")), "utf-8"),
            0xDA: lambda: str(self._take(self._unpack(">H")), "utf-8"),
            0xDB: lambda: str(self._take(self._unpack(">I")), "utf-8"),
            0xDC: lambda: self._array(self._unpack(">H")),
            0xDD: lambda: self._array(self._unpack(">I")),
            0xDE: lambda: self._map(self._unpack(">H")),
            0xDF: lambda: self._map(self._unpack(">I")),
        }

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def _ext(self, n: int):
        code = self._unpack(">b")
        payload = bytes(self._take(n))
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        return _ndarray_from_ext(payload)

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        fixed = self._table.get(b)
        if fixed is None:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        return fixed()

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def msgpack_restore(data: bytes):
    """Decode one msgpack document (flax's ndarray ext included)."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack document")
    return out


# -- flagship weights --------------------------------------------------------

FLAGSHIP_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "weights", "flagship_synth_bf16.msgpack")


def read_flagship(path: str = FLAGSHIP_WEIGHTS):
    """(flax variable tree of f32 numpy arrays, sidecar dict). The blob's
    sha256 must match the one its sidecar JSON records."""
    sidecar_path = path.replace(".msgpack", ".json")
    with open(sidecar_path) as f:
        sidecar = json.load(f)
    with open(path, "rb") as f:
        data = f.read()
    digest = hashlib.sha256(data).hexdigest()
    if digest != sidecar.get("sha256"):
        raise ValueError(f"{path}: sha256 {digest} does not match its sidecar "
                         f"{sidecar.get('sha256')}")
    return msgpack_restore(data), sidecar


def load_flagship(fold: bool = True, device="cuda",
                  path: str = FLAGSHIP_WEIGHTS):
    """The committed flagship weights as a torch-layout f32 state dict on
    ``device``, and the sidecar. ``fold=True`` returns BN-folded weights
    for ``YOLOv5(fused=True)``, folded on the host so they are bit-equal
    to the JAX package's fold."""
    dev = require_device(device)
    variables, sidecar = read_flagship(path)
    sd = {k: torch.from_numpy(v) for k, v in state_dict_from_flax(variables).items()}
    if fold:
        sd = fold_batchnorm(sd)
    return {k: v.to(dev) for k, v in sd.items()}, sidecar
