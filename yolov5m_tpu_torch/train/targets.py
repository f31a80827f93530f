"""Vectorized anchor-target assignment on the device.

Port of ``yolov5m_tpu/train/targets.py``, with the same semantics:

  * per gt box, anchors are ranked by wh-IoU; the best anchor of each scale
    claims the box's cell;
  * non-best anchors with wh-IoU > ignore_thresh mark their cell "ignore"
    (obj = -1) unless the cell is claimed;
  * a cell/anchor claimed by several boxes goes to the first box in label
    order: a scatter-min over box ids (``scatter_reduce(..., "amin")``);
  * deviation #3 of the JAX twin is kept: a box that loses its best
    anchor-cell gets no positive on that scale (no fallback to the
    next-best anchor).

Every scatter here reduces with ``amin`` or ``amax`` over flattened cell
indices, so duplicate indices give the same result in any order (an
``index_put_`` with duplicates would not be deterministic on CUDA). Cell
indices truncate like ``astype(int32)`` and ``argmax`` takes the first
maximum, as on the JAX side.

Grid target channels: (x_cell, y_cell, w_cell, h_cell, obj, class).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from yolov5m_tpu_torch.ops.boxes import iou_wh


def anchor_iou_all(wh: torch.Tensor, anchors_px: torch.Tensor) -> torch.Tensor:
    """wh-IoU of each box against all anchors.

    wh: (..., 2) normalized box sizes; anchors_px: (nl, na, 2) anchors in
    pixels at the canonical 640 scale. Returns (..., nl, na)."""
    anchors_n = anchors_px.reshape(-1, 2) / 640.0
    iou = iou_wh(wh[..., None, :], anchors_n)
    return iou.reshape(*wh.shape[:-1], anchors_px.shape[0], anchors_px.shape[1])


def _cell_index(b, a, i, j, na: int, ny: int, nx: int) -> torch.Tensor:
    """Flat index of cell (b, a, i, j) in a (bs, na, ny, nx) grid."""
    return ((b * na + a) * ny + i) * nx + j


def _winner_grid(label_mask: torch.Tensor, a_best: torch.Tensor,
                 i: torch.Tensor, j: torch.Tensor,
                 na: int, ny: int, nx: int) -> torch.Tensor:
    """Scatter-min claim tournament: the first valid box per (anchor, cell)
    wins. Returns (bs, na, ny, nx) int64 winning box ids, nb where no box
    claimed the cell."""
    bs, nb = label_mask.shape
    dev = label_mask.device
    box_ids = torch.arange(nb, device=dev).expand(bs, nb)
    claim = torch.where(label_mask, box_ids, torch.full_like(box_ids, nb))
    b = torch.arange(bs, device=dev)[:, None]
    idx = _cell_index(b, a_best, i, j, na, ny, nx)
    winner = torch.full((bs * na * ny * nx,), nb, dtype=torch.int64,
                        device=dev)
    winner.scatter_reduce_(0, idx.reshape(-1), claim.reshape(-1), "amin",
                           include_self=True)
    return winner.view(bs, na, ny, nx)


def _ignore_grid(iou_s: torch.Tensor, a_best: torch.Tensor,
                 label_mask: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
                 na: int, ny: int, nx: int,
                 ignore_iou_thresh: float) -> torch.Tensor:
    """(bs, na, ny, nx) bool: cells excluded from the objectness loss, any
    non-best anchor of this scale with IoU > thresh at the box's cell."""
    bs, nb = label_mask.shape
    dev = label_mask.device
    anchor_ids = torch.arange(na, device=dev)
    is_best = a_best[..., None] == anchor_ids
    cand = (iou_s > ignore_iou_thresh) & ~is_best & label_mask[..., None]
    b = torch.arange(bs, device=dev)[:, None, None]
    idx = _cell_index(b, anchor_ids, i[..., None], j[..., None], na, ny, nx)
    ign = torch.zeros(bs * na * ny * nx, dtype=torch.int32, device=dev)
    ign.scatter_reduce_(0, idx.reshape(-1), cand.reshape(-1).int(), "amax",
                        include_self=True)
    return ign.view(bs, na, ny, nx).bool()


def _cells(xy: torch.Tensor, ny: int, nx: int):
    """Grid coordinates (gx, gy) and truncated, clipped cell indices (j, i)."""
    gx = xy[..., 0] * nx
    gy = xy[..., 1] * ny
    j = gx.to(torch.int64).clamp(0, nx - 1)
    i = gy.to(torch.int64).clamp(0, ny - 1)
    return gx, gy, j, i


def build_grid_targets(labels: torch.Tensor, label_mask: torch.Tensor,
                       anchors_px: torch.Tensor,
                       grid_sizes: Sequence[Tuple[int, int]],
                       ignore_iou_thresh: float = 0.5) -> List[torch.Tensor]:
    """Per-scale dense grid targets for a padded label batch.

    labels: (bs, nb, 5) rows (class, x, y, w, h) normalized; label_mask:
    (bs, nb) bool; anchors_px: (nl, na, 2) pixels at 640; grid_sizes:
    [(ny, nx)] * nl. Returns nl tensors (bs, na, ny, nx, 6): (x_c, y_c,
    w_c, h_c, obj, cls), obj 1 (positive), 0 (background) or -1 (ignore).
    """
    bs, nb, _ = labels.shape
    na = anchors_px.shape[1]
    cls, xy, wh = labels[..., 0], labels[..., 1:3], labels[..., 3:5]
    iou = anchor_iou_all(wh, anchors_px)                  # (bs, nb, nl, na)
    best_anchor = iou.argmax(-1)                          # (bs, nb, nl)

    targets = []
    for s, (ny, nx) in enumerate(grid_sizes):
        gx, gy, j, i = _cells(xy, ny, nx)
        a_best = best_anchor[..., s]
        winner = _winner_grid(label_mask, a_best, i, j, na, ny, nx)
        has_pos = winner < nb
        w_idx = torch.where(has_pos, winner, torch.zeros_like(winner))
        flat = w_idx.reshape(bs, -1)

        def take(v):  # (bs, nb) -> (bs, na, ny, nx)
            return v.gather(1, flat).view(bs, na, ny, nx)

        tx = take(gx) - take(j).float()
        ty = take(gy) - take(i).float()
        tw = take(wh[..., 0] * nx)
        th = take(wh[..., 1] * ny)
        tc = take(cls)
        ign = _ignore_grid(iou[..., s, :], a_best, label_mask, i, j,
                           na, ny, nx, ignore_iou_thresh)
        one, zero = torch.ones_like(tx), torch.zeros_like(tx)
        obj = torch.where(has_pos, one, torch.where(ign, -one, zero))
        tgt = torch.stack([tx, ty, tw, th, obj, tc], -1)
        background = torch.stack([zero] * 4 + [obj, zero], -1)
        targets.append(torch.where(has_pos[..., None], tgt, background))
    return targets


def build_sparse_grid_targets(labels: torch.Tensor, label_mask: torch.Tensor,
                              anchors_px: torch.Tensor,
                              grid_sizes: Sequence[Tuple[int, int]],
                              ignore_iou_thresh: float = 0.5) -> List[dict]:
    """Sparse form of build_grid_targets for the loss: per-box rows (each box
    claims at most one cell per scale) instead of a dense grid.

    Returns per-scale dicts:
      b, a, gj, gi: (bs*nb,) int64 batch/anchor/cell indices
      tbox: (bs*nb, 4) (x_cell, y_cell, w_cells, h_cells)
      tcls: (bs*nb,) int64
      valid: (bs*nb,) bool, box is real AND won its (a, i, j) cell
      ign: (bs, na, ny, nx) bool, ignore cells with no positive
    """
    bs, nb, _ = labels.shape
    na = anchors_px.shape[1]
    dev = labels.device
    cls, xy, wh = labels[..., 0], labels[..., 1:3], labels[..., 3:5]
    iou = anchor_iou_all(wh, anchors_px)
    best_anchor = iou.argmax(-1)
    b = torch.arange(bs, device=dev)[:, None].expand(bs, nb)
    box_ids = torch.arange(nb, device=dev).expand(bs, nb)

    out = []
    for s, (ny, nx) in enumerate(grid_sizes):
        gx, gy, j, i = _cells(xy, ny, nx)
        a_best = best_anchor[..., s]
        winner = _winner_grid(label_mask, a_best, i, j, na, ny, nx)
        won = winner[b, a_best, i, j] == box_ids
        valid = label_mask & won
        tbox = torch.stack([gx - j.float(), gy - i.float(),
                            wh[..., 0] * nx, wh[..., 1] * ny], -1)
        ign = _ignore_grid(iou[..., s, :], a_best, label_mask, i, j,
                           na, ny, nx, ignore_iou_thresh)
        ign = ign & ~(winner < nb)
        n = bs * nb
        out.append({
            "b": b.reshape(n), "a": a_best.reshape(n),
            "gj": i.reshape(n), "gi": j.reshape(n),
            "tbox": tbox.reshape(n, 4),
            "tcls": cls.reshape(n).long(),
            "valid": valid.reshape(n),
            "ign": ign,
        })
    return out


def build_flat_targets(labels: torch.Tensor, label_mask: torch.Tensor,
                       anchors_px: torch.Tensor,
                       grid_sizes: Sequence[Tuple[int, int]],
                       anchor_t: float = 4.0,
                       strides: Sequence[int] = (8, 16, 32)) -> List[dict]:
    """Ultralytics-style candidate matching, fixed shape.

    Per scale: every (box, anchor) pair whose wh ratio satisfies
    max(r, 1/r) < anchor_t, expanded to its cell plus up to 2 neighbour
    cells (centre, left, up, right, down offsets of 0.5). The regression
    offset is taken from the clipped cell, so an edge box (x == 1.0)
    regresses toward cell nx-1 with dx = 1.0.

    Returns per-scale dicts (M = 5*na*bs*nb rows):
      b, a, gj, gi: (M,) int64; tbox: (M, 4) (dx, dy, w_cells, h_cells);
      tcls: (M,) int64; anchor_wh: (M, 2) anchor in cell units;
      valid: (M,) bool
    """
    bs, nb, _ = labels.shape
    na = anchors_px.shape[1]
    dev = labels.device
    g = 0.5
    # centre, left(+x), up(+y), right, down; made on the device, since a
    # small host-to-card copy waits for the card's stream
    eye = torch.eye(2, device=dev)
    offsets = torch.cat([torch.zeros(1, 2, device=dev), eye, -eye]) * g
    cls = labels[..., 0].reshape(-1)
    xy = labels[..., 1:3].reshape(-1, 2)
    wh = labels[..., 3:5].reshape(-1, 2)
    n = xy.shape[0]
    bidx = torch.arange(bs, device=dev).repeat_interleave(nb)
    vmask = label_mask.reshape(-1)

    out = []
    for s, (ny, nx) in enumerate(grid_sizes):
        gxy = torch.stack([xy[:, 0] * nx, xy[:, 1] * ny], -1)
        gwh = torch.stack([wh[:, 0] * nx, wh[:, 1] * ny], -1)
        anc = anchors_px[s] / float(strides[s])

        r = gwh[:, None, :] / anc[None, :, :]                 # (N, na, 2)
        ratio_ok = torch.maximum(r, 1.0 / r).amax(-1) < anchor_t
        pair_ok = ratio_ok & vmask[:, None]

        jx = (gxy[:, 0] % 1.0 < g) & (gxy[:, 0] > 1.0)
        ky = (gxy[:, 1] % 1.0 < g) & (gxy[:, 1] > 1.0)
        lx = ((nx - gxy[:, 0]) % 1.0 < g) & (nx - gxy[:, 0] > 1.0)
        my = ((ny - gxy[:, 1]) % 1.0 < g) & (ny - gxy[:, 1] > 1.0)
        off_ok = torch.stack([torch.ones_like(jx), jx, ky, lx, my], 0)
        valid = off_ok[:, :, None] & pair_ok[None]            # (5, N, na)

        gij = torch.floor(gxy[None, :, None, :] - offsets[:, None, None, :])
        gij = gij.long().expand(5, n, na, 2)
        gi = gij[..., 0].clamp(0, nx - 1)
        gj = gij[..., 1].clamp(0, ny - 1)
        dxy = gxy[None, :, None, :] - torch.stack([gi, gj], -1).float()
        tbox = torch.cat([dxy, gwh[None, :, None, :].expand_as(dxy)], -1)

        m = 5 * n * na
        a_ids = torch.arange(na, device=dev).expand(5, n, na)
        out.append({
            "b": bidx[None, :, None].expand(5, n, na).reshape(m),
            "a": a_ids.reshape(m),
            "gj": gj.reshape(m),
            "gi": gi.reshape(m),
            "tbox": tbox.reshape(m, 4),
            "tcls": cls[None, :, None].expand(5, n, na).reshape(m).long(),
            "anchor_wh": anc[None, None].expand(5, n, na, 2).reshape(m, 2),
            "valid": valid.reshape(m),
        })
    return out
