"""Batched mosaic-4 on the device: port of ``yolov5m_tpu/ops/mosaic.py``.

The semantics of the host mosaic (data/augment.py mosaic4) on equal-size
s x s sources: a 2s x 2s canvas with a center (yc, xc) in [s/2, 3s/2), one
source per quadrant, fill 114/255, a 2x downscale by the 2x2 box mean
(what cv2 INTER_LINEAR does at exactly half scale), labels shifted into the
canvas, clipped and kept when at least MIN_VISIBILITY of their area stays.

Two properties keep the result equal to the JAX package's:
  * centers are rounded down to even coordinates, so the 2x downscale
    commutes with placement: every source is halved once (the 2x2 mean,
    summed in the JAX order) and output pixel (i, j) of quadrant k is the
    halved source at (i - dy_k/2, j - dx_k/2), or the fill outside it;
  * surviving labels are compacted into the fixed ``nb`` slots in source
    order (quadrant k = 0..3, then label order), like the loader's
    first-n truncation.

The JAX package builds each quadrant from dynamic rolls under lax.map, a
form chosen for XLA:TPU; here the placement is one gather over the batch.
"""

from __future__ import annotations

from typing import Optional

import torch

from yolov5m_tpu_torch.data.augment import MIN_VISIBILITY

FILL = 114.0 / 255.0


def _halve(images: torch.Tensor) -> torch.Tensor:
    """(..., s, s, 3) -> (..., s/2, s/2, 3) by the exact 2x2 box mean."""
    return (images[..., 0::2, 0::2, :] + images[..., 0::2, 1::2, :] +
            images[..., 1::2, 0::2, :] + images[..., 1::2, 1::2, :]) * 0.25


def _place(half: torch.Tensor, idx: torch.Tensor, centers: torch.Tensor,
           s: int, fill: float) -> torch.Tensor:
    """(B, s, s, 3) mosaics from the halved sources half (B, h, h, 3),
    idx (B, 4) and even centers (B, 2)."""
    b, h = idx.shape[0], s // 2
    dev = half.device
    yc2, xc2 = centers[:, 0] // 2, centers[:, 1] // 2            # (B,)
    i = torch.arange(s, device=dev)
    in_bottom = i[None, :] >= yc2[:, None]                      # (B, s)
    in_right = i[None, :] >= xc2[:, None]
    row = i[None, :] - yc2[:, None] + torch.where(in_bottom, 0, h)
    col = i[None, :] - xc2[:, None] + torch.where(in_right, 0, h)
    row_ok = (row >= 0) & (row < h)
    col_ok = (col >= 0) & (col < h)
    quad = 2 * in_bottom[:, :, None].long() + in_right[:, None, :].long()
    src = torch.gather(idx.long(), 1, quad.reshape(b, -1)).reshape(b, s, s)
    flat = (src * h + row.clamp(0, h - 1)[:, :, None]) * h \
        + col.clamp(0, h - 1)[:, None, :]
    out = half.reshape(-1, half.shape[-1])[flat.reshape(-1)]
    out = out.reshape(b, s, s, half.shape[-1])
    ok = (row_ok[:, :, None] & col_ok[:, None, :])[..., None]
    return torch.where(ok, out, torch.full((), fill, dtype=out.dtype,
                                           device=dev))


def _mosaic_labels(labels, mask, idx, centers, s: int,
                   min_visibility: float):
    """labels (B, nb, 5), mask (B, nb), idx (B, 4), centers (B, 2) ->
    (labels (B, nb, 5), mask (B, nb)) of the mosaics."""
    b, nb = labels.shape[:2]
    dev = labels.device
    labs4 = labels[idx.long()]                                  # (B, 4, nb, 5)
    mask4 = mask[idx.long()]                                    # (B, 4, nb)
    cls = labs4[..., 0]
    cx, cy, w, h = labs4[..., 1], labs4[..., 2], labs4[..., 3], labs4[..., 4]
    corners = torch.stack([cx - w / 2, cy - h / 2,
                           cx + w / 2, cy + h / 2], -1)         # (B, 4, nb, 4)
    left = torch.tensor([True, False, True, False], device=dev)
    top = torch.tensor([True, True, False, False], device=dev)
    yc, xc = centers[:, 0:1], centers[:, 1:2]                   # (B, 1)
    off_x = torch.where(left, xc - s, xc).float()               # (B, 4)
    off_y = torch.where(top, yc - s, yc).float()
    off = torch.stack([off_x, off_y, off_x, off_y], -1)[:, :, None, :]
    c = (corners * s + off) / (2 * s)
    area0 = (c[..., 2] - c[..., 0]).clamp(min=0) * \
        (c[..., 3] - c[..., 1]).clamp(min=0)
    cc = c.clamp(0.0, 1.0)
    area = (cc[..., 2] - cc[..., 0]).clamp(min=0) * \
        (cc[..., 3] - cc[..., 1]).clamp(min=0)
    keep = mask4 & (area / area0.clamp(min=1e-9) >= min_visibility)

    keep_f = keep.reshape(b, -1)                                # (B, 4nb)
    rows = torch.stack([cls, (cc[..., 0] + cc[..., 2]) / 2,
                        (cc[..., 1] + cc[..., 3]) / 2,
                        cc[..., 2] - cc[..., 0],
                        cc[..., 3] - cc[..., 1]], -1).reshape(b, -1, 5)
    rank = keep_f.long().cumsum(1) - 1
    # every dropped row goes to the spare slot nb, which is cut off
    slot = torch.where(keep_f & (rank < nb), rank, torch.full_like(rank, nb))
    out_labels = torch.zeros(b, nb + 1, 5, device=dev, dtype=labels.dtype)
    out_labels.scatter_(1, slot[..., None].expand(-1, -1, 5), rows)
    out_mask = torch.zeros(b, nb + 1, dtype=torch.bool, device=dev)
    out_mask.scatter_(1, slot, keep_f)
    return out_labels[:, :nb], out_mask[:, :nb]


def mosaic_batch(images: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor, idx: torch.Tensor, centers: torch.Tensor,
                 min_visibility: float = MIN_VISIBILITY, fill: float = FILL):
    """Mosaic i is built from batch rows idx[i] (4 sources) around
    centers[i] = (yc, xc), each in [s//2, 3s//2) and rounded down to even.

    images (B, s, s, 3) float in [0, 1]; labels (B, nb, 5); mask (B, nb);
    idx (B, 4) int; centers (B, 2) int. Returns (images, labels, mask)."""
    s = images.shape[1]
    centers = centers - centers % 2
    img = _place(_halve(images), idx, centers, s, fill)
    lab, msk = _mosaic_labels(labels, mask, idx, centers, s, min_visibility)
    return img, lab, msk


def random_mosaic_batch(generator: Optional[torch.Generator], images, labels,
                        mask, p: float, min_visibility: float = MIN_VISIBILITY,
                        fill: float = FILL):
    """Each row becomes a mosaic with probability p, its three partners
    drawn uniformly from the batch and its center uniformly from
    [s//2, 3s//2)^2. Every mosaic is computed, then selected per row."""
    b, s = images.shape[0], images.shape[1]
    kw = dict(generator=generator, device=images.device)
    partners = torch.randint(0, b, (b, 3), **kw)
    idx = torch.cat([torch.arange(b, device=images.device)[:, None],
                     partners], 1)
    centers = torch.randint(s // 2, 3 * s // 2, (b, 2), **kw)
    apply = torch.rand((b,), **kw) < p
    m_img, m_lab, m_mask = mosaic_batch(images, labels, mask, idx, centers,
                                        min_visibility, fill)
    return (torch.where(apply[:, None, None, None], m_img, images),
            torch.where(apply[:, None, None], m_lab, labels),
            torch.where(apply[:, None], m_mask, mask))
