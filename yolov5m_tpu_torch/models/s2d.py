"""Space-to-depth stem rewrite.

Port of ``yolov5m_tpu/models/s2d.py``. The stem conv (6x6, stride 2, pad 2
on 3 channels) equals a 3x3 stride-1 conv (pad 1) over the 2x2
space-to-depth transform of the input, which has 12 channels:

  out(y,x) = sum_{dy,dx<6} W6[o, c, dy, dx] * in(c, 2y+dy-2, 2x+dx-2)
           = sum_{a,b<3, p,q<2} W3[o, (2p+q)C + c, a, b] * z(y+a-1, x+b-1)
  with z(u,v)[(2p+q)C + c] = in(c, 2u+p, 2v+q),
       W3[o, (2p+q)C + c, a, b] = W6[o, c, 2a+p, 2b+q].

Exact up to float associativity. ``YOLOv5(stem_s2d=True)`` applies
``space_to_depth2`` to the NHWC input (after the cast to the compute dtype,
before the NHWC -> NCHW view) and its stem is ``CBL(12, fo, 3, 1, 1)``;
``stem_weights_to_s2d`` converts a state dict for it.
"""

from __future__ import annotations

from typing import Dict

import torch

STEM_WEIGHT = "backbone.0.cbl.0.weight"


def space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), channel order (p, q, c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 2, 4, 5)               # (b, h2, w2, p, q, c)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def stem_kernel_to_s2d(w6: torch.Tensor) -> torch.Tensor:
    """(O, C, 6, 6) OIHW stem kernel -> (O, 4C, 3, 3) for the s2d stem."""
    o, c, kh, kw = w6.shape
    if (kh, kw) != (6, 6):
        raise ValueError(f"the stem kernel must be 6x6, got {kh}x{kw}")
    w = w6.reshape(o, c, 3, 2, 3, 2)              # (o, c, a, p, b, q)
    return w.permute(0, 3, 5, 1, 2, 4).reshape(o, 4 * c, 3, 3)


def stem_weights_to_s2d(state_dict: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """A state dict of ``YOLOv5(stem_s2d=False)`` (BN folded or not) ->
    one for ``stem_s2d=True``: only the stem's conv weight changes shape."""
    return {k: stem_kernel_to_s2d(v) if k == STEM_WEIGHT else v
            for k, v in state_dict.items()}
