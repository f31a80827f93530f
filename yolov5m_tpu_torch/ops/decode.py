"""Grid construction and prediction decoding: port of ``yolov5m_tpu/ops/decode.py``.

  xy = (2*sig(txy) + grid - 0.5) * stride
  wh = (2*sig(twh))**2 * anchor * stride

emitting (class, conf, cx, cy, w, h) rows, (bs, sum(na*ny*nx), 6), and
the target path ``decode_grid_targets``.
"""

from __future__ import annotations

from typing import Sequence

import torch


def make_grid(ny: int, nx: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(ny, nx, 2) grid of (x, y) cell indices."""
    ys, xs = torch.meshgrid(torch.arange(ny, device=device),
                            torch.arange(nx, device=device), indexing="ij")
    return torch.stack([xs, ys], -1).to(dtype)


def decode_layer(pred: torch.Tensor, anchors: torch.Tensor,
                 stride: int) -> torch.Tensor:
    """One head scale (bs, na, ny, nx, 5+nc) raw logits, with (na, 2)
    stride-normalized anchors -> (bs, na*ny*nx, 6) rows."""
    bs, na, ny, nx, _ = pred.shape
    p = torch.sigmoid(pred.float())
    grid = make_grid(ny, nx, device=pred.device)
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=pred.device)
    xy = (2.0 * p[..., 0:2] + grid[None, None] - 0.5) * stride
    wh = (2.0 * p[..., 2:4]) ** 2 * (anchors * stride)[None, :, None, None, :]
    obj = p[..., 4:5]
    best_class = p[..., 5:].argmax(-1, keepdim=True).float()
    rows = torch.cat([best_class, obj, xy, wh], -1)
    return rows.reshape(bs, na * ny * nx, 6)


def decode_predictions(preds: Sequence[torch.Tensor], anchors,
                       strides: Sequence[int] = (8, 16, 32)) -> torch.Tensor:
    """Decode all scales and concatenate: (bs, sum(na*ny*nx), 6) rows
    (class, conf, cx, cy, w, h) in pixels. anchors: (nl, na, 2)."""
    return torch.cat([decode_layer(p, anchors[i], strides[i])
                      for i, p in enumerate(preds)], 1)


def decode_grid_targets(targets: Sequence[torch.Tensor],
                        strides: Sequence[int] = (8, 16, 32)) -> torch.Tensor:
    """Grid-encoded targets (bs, na, ny, nx, 6) with channels (x_cell,
    y_cell, w_cell, h_cell, obj, class) back to (bs, sum(na*ny*nx), 6) rows
    (class, obj, cx, cy, w, h) in pixels: xy = (txy + grid) * stride,
    wh = twh * stride."""
    outs = []
    for t, s in zip(targets, strides):
        bs, na, ny, nx, _ = t.shape
        grid = make_grid(ny, nx, device=t.device)
        xy = (t[..., 0:2] + grid[None, None]) * s
        wh = t[..., 2:4] * s
        outs.append(torch.cat([t[..., 5:6], t[..., 4:5], xy, wh], -1)
                    .reshape(bs, na * ny * nx, 6))
    return torch.cat(outs, 1)
