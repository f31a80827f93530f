"""A PyTorch checkpoint of the reference model -> the port's weights.

Port of ``yolov5m_tpu/utils/torch_import.py``. A ``.pt`` holding the
reference model's state dict (bare, or under "state_dict") becomes a
torch-layout f32 state dict: ``num_batches_tracked`` and ``head.anchors``
are dropped, and with ``drop_head`` so is every ``head.`` key (fine-tuning
to another class count, the reference's yolov5m_coco_nh.pt pattern).
``torch_checkpoint_to_npz`` writes it as the npz that ``--weights`` and
``--load_coco_weights`` read; detect, serve and export also take the
``.pt`` itself as ``--weights``.

The file is read with ``torch.load(weights_only=True)``: tensors, numbers,
strings and containers only, never arbitrary pickled objects. (The JAX
package's copy also unpickles a whole pickled module.)

Usage:
  python -m yolov5m_tpu_torch.utils.torch_import yolov5m_coco.pt \\
      yolov5m_coco.npz [--no-head]
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch


def load_torch_state_dict(pt_path: str,
                          drop_head: bool = False) -> Dict[str, np.ndarray]:
    """The reference checkpoint's state dict as f32 numpy arrays, without
    ``num_batches_tracked``, ``head.anchors`` and, with drop_head, the
    head."""
    obj = torch.load(pt_path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        raise ValueError(f"{pt_path}: not a state dict")
    out = {}
    for k, v in obj.items():
        if k.endswith("num_batches_tracked") or k == "head.anchors":
            continue
        if drop_head and k.startswith("head."):
            continue
        out[k] = v.detach().cpu().numpy().astype(np.float32)
    return out


def torch_checkpoint_to_npz(pt_path: str, npz_path: str,
                            drop_head: bool = False) -> int:
    """Save the checkpoint's state dict as an npz. Returns the key count."""
    out = load_torch_state_dict(pt_path, drop_head)
    np.savez(npz_path, **out)
    return len(out)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("pt_path")
    p.add_argument("npz_path")
    p.add_argument("--no-head", action="store_true",
                   help="drop head weights (fine-tune to a new class count)")
    args = p.parse_args(argv)
    n = torch_checkpoint_to_npz(args.pt_path, args.npz_path, args.no_head)
    print(f"wrote {n} arrays to {args.npz_path}")


if __name__ == "__main__":
    main()
