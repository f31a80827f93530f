"""Fixed-shape batched NMS: port of ``yolov5m_tpu/ops/nms.py``.

Suppression backends, identical results (all exactly greedy):
  * "torch"      - the batched fixpoint over the (K, K) suppress matrix
                   (_greedy_suppress_fixpoint); the plain version;
  * "torch_loop" - the K-step sequential scan (_greedy_suppress);
  * "cuda"       - the hand-written kernel (ops/cuda/nms_kernel.py), one
                   launch per call: on CUDA tensors it runs or raises (K
                   above nms_kernel.MAX_K raises); on CPU tensors its
                   wrapper runs the plain version, "torch".
"auto" picks "cuda" for CUDA tensors and "torch" for CPU tensors.

Output rows are (class, conf, x1, y1, x2, y2); classes are separated by an
exact same-class mask.
"""

from __future__ import annotations

import torch

from yolov5m_tpu_torch.ops.boxes import pairwise_iou_xyxy, xywh_to_xyxy
from yolov5m_tpu_torch.ops.cuda import nms_kernel

NEG_INF = -1e10

BACKENDS = ("auto", "torch", "torch_loop", "cuda")


def resolve_backend(backend: str, device) -> str:
    """Resolve "auto": the CUDA kernel for CUDA tensors, the plain fixpoint
    for CPU tensors. On the card a K above the kernel's cap raises in the
    kernel's wrapper rather than quietly running the plain version."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown NMS backend {backend!r}; one of {BACKENDS}")
    if backend != "auto":
        return backend
    if torch.device(device).type == "cuda":
        return "cuda"
    return "torch"


def _suppress_matrix(boxes: torch.Tensor, cls: torch.Tensor,
                     iou_threshold: float) -> torch.Tensor:
    """(bs, K, K) bool: i suppresses j (same class, IoU > t, j > i)."""
    k = boxes.shape[1]
    iou = pairwise_iou_xyxy(boxes, boxes)
    same = cls[:, :, None] == cls[:, None, :]
    upper = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    return (iou > iou_threshold) & same & upper    # compared in f32


def _greedy_suppress(smat: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Sequential greedy scan, batched over images.

    smat: (bs, K, K) bool, True where row i suppresses column j (rows and
    columns score-descending; entries at j <= i are ignored).
    valid: (bs, K) bool. Returns the (bs, K) bool keep mask."""
    k = smat.shape[1]
    col_ids = torch.arange(k, device=smat.device)
    alive = valid.clone()
    for i in range(k):
        keeper = alive[:, i] & valid[:, i]
        row = smat[:, i] & (col_ids > i)
        alive = torch.where(keeper[:, None], alive & ~row, alive)
    return alive


def _greedy_suppress_fixpoint(smat: torch.Tensor,
                              valid: torch.Tensor) -> torch.Tensor:
    """Greedy NMS as the unique fixpoint of
        F(a)[j] = valid[j] & not OR_{i<j} (a[i] & S[i,j]),
    iterated from a = valid (see the JAX twin for the proof). Each step is
    one batched 0/1 matvec, exact in f32 for any K.

    smat: (bs, K, K) bool, strictly upper-triangular. Returns (bs, K) bool,
    bit-identical to the sequential scan.

    Under torch.export the loop, whose length depends on the data, becomes
    a while_loop operator in the program (utils/export.py)."""
    s = smat.float()

    def step(a):
        return valid & ~(torch.bmm(a.float()[:, None, :], s)[:, 0] > 0.5)

    if torch.compiler.is_exporting():
        from torch._higher_order_ops.while_loop import while_loop

        def body(a, _):
            a_new = step(a)
            return a_new, (a_new == a).all()

        a, _ = while_loop(lambda a, done: ~done, body,
                          (valid.clone(), torch.zeros((), dtype=torch.bool,
                                                      device=valid.device)))
        return a
    a = valid
    while True:
        a_new = step(a)
        if torch.equal(a_new, a):
            return a
        a = a_new


def _prepare(rows: torch.Tensor, conf_threshold: float, k: int):
    """Confidence gate + top-K + xywh -> xyxy, batched.

    rows: (bs, N, 6) (class, conf, cx, cy, w, h). Returns (boxes (bs, K, 4),
    cls (bs, K), conf (bs, K), valid (bs, K)) by descending confidence;
    equal scores keep index order (lax.top_k is stable)."""
    conf = rows[..., 1]
    gated = torch.where(conf > conf_threshold, conf,
                        torch.full_like(conf, NEG_INF))
    top_scores, top_idx = torch.sort(gated, dim=1, descending=True,
                                      stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    cand = rows.gather(1, top_idx[..., None].expand(-1, -1, rows.shape[-1]))
    valid = top_scores > NEG_INF / 2
    return xywh_to_xyxy(cand[..., 2:6]), cand[..., 0], cand[..., 1], valid


def suppress(boxes: torch.Tensor, cls: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float, backend: str = "torch") -> torch.Tensor:
    """Greedy class-aware suppression over score-sorted candidates, the
    single backend dispatch point (batched_nms and fused_detect route here).

    boxes: (bs, K, 4) xyxy f32; cls: (bs, K) f32; valid: (bs, K) bool.
    backend: a resolved name ("torch" | "torch_loop" | "cuda"). "cuda" on
    CUDA tensors launches the kernel once or raises; it never falls back to
    a plain version.
    Returns the (bs, K) bool keep mask, identical across backends."""
    if backend == "cuda":
        return nms_kernel.greedy_keep_cuda(
            boxes.contiguous(), cls.contiguous(), valid.contiguous(),
            iou_threshold)
    smat = _suppress_matrix(boxes, cls, iou_threshold)
    if backend == "torch_loop":
        return _greedy_suppress(smat, valid)
    if backend == "torch":
        return _greedy_suppress_fixpoint(smat, valid)
    raise ValueError(f"suppress takes a resolved backend, got {backend!r}")


def _compact(boxes, cls, conf, keep, max_detections: int):
    """Scatter the kept (score-sorted) rows of each image into the first
    max_detections slots. Returns (out (bs, max_det, 6), valid (bs, max_det)).

    Every row that is not kept, or is kept beyond the cap, goes to the dummy
    slot max_detections, which is cut off: that is the only index the
    scatter sees more than once, so which of those writes lands there does
    not matter."""
    bs = keep.shape[0]
    rank = torch.cumsum(keep.int(), dim=1) - 1
    slot = torch.where(keep & (rank < max_detections), rank,
                       torch.full_like(rank, max_detections)).long()
    out_rows = torch.cat([cls[..., None], conf[..., None], boxes], -1)
    out = torch.zeros((bs, max_detections + 1, 6), dtype=out_rows.dtype,
                      device=out_rows.device)
    out.scatter_(1, slot[..., None].expand(-1, -1, 6), out_rows)
    valid = torch.zeros((bs, max_detections + 1), dtype=torch.bool,
                        device=keep.device)
    valid.scatter_(1, slot, keep)
    return out[:, :max_detections], valid[:, :max_detections]


def nms_single(rows: torch.Tensor, iou_threshold: float,
               conf_threshold: float, max_detections: int = 300,
               pre_nms_topk: int = 1024):
    """NMS for one image: rows (N, 6) (class, conf, cx, cy, w, h) ->
    (out (max_detections, 6), valid (max_detections,))."""
    out, valid = batched_nms(rows[None], iou_threshold, conf_threshold,
                             max_detections, pre_nms_topk)
    return out[0], valid[0]


def batched_nms(rows: torch.Tensor, iou_threshold: float,
                conf_threshold: float, max_detections: int = 300,
                pre_nms_topk: int = 1024, backend: str = "auto"):
    """Batched NMS over decoded rows (bs, N, 6) (class, conf, cx, cy, w, h).

    Returns out (bs, max_detections, 6) rows (class, conf, x1, y1, x2, y2)
    and valid (bs, max_detections) bool."""
    k = min(pre_nms_topk, rows.shape[1])
    backend = resolve_backend(backend, rows.device)
    boxes, cls, conf, valid = _prepare(rows, conf_threshold, k)
    keep = suppress(boxes, cls, valid, iou_threshold, backend=backend)
    return _compact(boxes, cls, conf, keep, max_detections)
