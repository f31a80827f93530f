"""Pipeline-parallel (PP) inference and training: the model's stages over
a "pipe" axis, GPipe style.

Port of ``yolov5m_tpu/parallel/pp.py``. The forward is a linear program of
19 steps over named values (``grid.STEPS``); S - 1 cuts split it into S
contiguous stages, stage s on the pipe axis's s-th device, and M
micro-batches stream through them in M + S - 1 ticks: at tick t stage s
works on micro-batch t - s. The values a later stage reads (the trunk, and
the P3/P4 taps and neck stashes that skip several steps) are found by
liveness (``StagePlan``), packed into one (mb, buf_len) carry in the
compute dtype and handed to the next stage's device by a copy. JAX runs
the schedule as one ``lax.scan`` with ``ppermute``; here one process
issues it tick by tick, and on several cards the stages overlap by CUDA's
asynchrony (not measured: the runs so far had one card).

Inference runs ``fused_detect`` on the last stage for each micro-batch as
it drains: M calls, so M NMS launches a call (M x D with a data axis, one
per replica and micro-batch).

Training (``PipelineTrainer``) is M sequential single-device steps at
accumulate=M, as JAX's is: every stage sees micro-batches in order, so the
BN running statistics move per micro-batch in the same order; each
micro-batch's loss is composed from ``YoloLoss.num_den`` with the
numerators and denominators summed over the data replicas; one backward
of the summed losses sums the gradients over micro-batches (GPipe:
forward all, then backward all, every micro-batch's activations held, or
recomputed under the model's remat); then clip, Adam and the EMA fire
once, the step count advances by M and the EMA's decay is taken at
step // M. The metrics are the micro-batch means; grad_norm is the norm of
the summed gradient.

DPxPP (``make_dp_pp_mesh``, ``data_axis="data"``): every replica
pipelines its shard of each micro-batch, micro-batch m being the global
rows [m*D*mb, (m+1)*D*mb) and replica d its rows [d*mb, (d+1)*mb) of
those. BatchNorm uses each replica's own statistics and the running
buffers are averaged over the replicas, DP's local-BN semantics, unlike SP
and TP.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from yolov5m_tpu_torch.ops.postprocess import fused_detect
from yolov5m_tpu_torch.parallel.grid import (N_STEPS, STEPS, ReplicaOps,
                                             Weights, check_float_model,
                                             compute_dtype)
from yolov5m_tpu_torch.parallel.mesh import Mesh, resolve_data_axis
from yolov5m_tpu_torch.train.trainer import Trainer, global_norm

# Default cuts (stage boundaries as step indices) per stage count, JAX's:
# the high-resolution early convs are heavy, so stage 0 gets fewer steps
DEFAULT_CUTS = {
    2: (7,),
    4: (4, 8, 13),
    8: (2, 4, 6, 8, 11, 13, 16),
}


class StagePlan:
    """Steps per stage, the live values at each cut, and the layout of the
    one (mb, buf_len) carry a cut hands on. ``value_shapes`` are NCHW, the
    port's layout (JAX's are NHWC); a value is packed in NHWC order, which
    for a channels_last tensor is a view."""

    def __init__(self, model, image_shape: Tuple[int, ...], n_stages: int,
                 cuts: Optional[Sequence[int]] = None):
        if getattr(model, "stem_s2d", False):
            raise ValueError("PP does not support the s2d stem rewrite")
        check_float_model(model, "PP")
        if cuts is None:
            cuts = DEFAULT_CUTS.get(n_stages) or tuple(
                round(N_STEPS * i / n_stages) for i in range(1, n_stages))
        cuts = tuple(cuts)
        if len(cuts) != n_stages - 1:
            raise ValueError(f"{n_stages} stages need {n_stages - 1} cuts, "
                             f"got {cuts}")
        if not all(0 < c < N_STEPS for c in cuts) or \
                tuple(sorted(set(cuts))) != cuts:
            raise ValueError(f"cuts must increase within (0, {N_STEPS}): "
                             f"{cuts}")
        bounds = (0,) + cuts + (N_STEPS,)
        self.n_stages = n_stages
        self.stage_steps = [list(range(bounds[b], bounds[b + 1]))
                            for b in range(n_stages)]

        # value shapes: the whole program once on the meta device
        meta = torch.device("meta")
        ops = ReplicaOps(model, Weights(), train=False)
        with torch.no_grad():
            vals = ops.run({"x0": [ops.prep(
                torch.empty(image_shape, device=meta), meta)]}, STEPS)
        self.value_shapes = {k: tuple(v[0].shape) for k, v in vals.items()
                             if k != "out"}
        self.value_dtype = compute_dtype(model)
        self.mb = image_shape[0]

        # liveness at each cut: produced before it, read at or after it
        produced_at = {name: i for i, (name, _, _, _) in enumerate(STEPS)}
        self.live = []                  # live[b]: names crossing cut b
        for c in cuts:
            alive = set()
            for i in range(c, N_STEPS):
                for r in STEPS[i][1]:
                    if r != "x0" and produced_at[r] < c:
                        alive.add(r)
            self.live.append(sorted(alive))
        self.buf_len = max((sum(self._slot(n) for n in names)
                            for names in self.live), default=1) or 1
        # module (state-dict prefix) -> the stage that runs it
        self.module_stage = {STEPS[i][2]: b
                             for b, idxs in enumerate(self.stage_steps)
                             for i in idxs}

    def _slot(self, name: str) -> int:
        return int(np.prod(self.value_shapes[name][1:]))

    def pack(self, vals: Dict[str, torch.Tensor], boundary: int):
        """Cut ``boundary``'s live set as one (mb, buf_len) tensor in the
        compute dtype."""
        names = self.live[boundary]
        flat = [vals[n].permute(0, 2, 3, 1).reshape(self.mb, -1)
                .to(self.value_dtype) for n in names]
        buf = torch.cat(flat, 1) if len(flat) > 1 else flat[0]
        pad = self.buf_len - buf.shape[1]
        return F.pad(buf, (0, pad)) if pad else buf

    def unpack(self, buf: torch.Tensor, boundary: int) -> Dict[str, torch.Tensor]:
        vals, off = {}, 0
        for n in self.live[boundary]:
            _, c, h, w = self.value_shapes[n]
            ln = c * h * w
            vals[n] = buf[:, off:off + ln].reshape(self.mb, h, w, c).permute(
                0, 3, 1, 2)
            off += ln
        return vals


def _pipeline(plan: StagePlan, ops: ReplicaOps, grid, n_micro: int, feed,
              drain) -> None:
    """The GPipe schedule over grid [replica][stage]: feed(m) gives
    micro-batch m's stage-0 input (one tensor a replica), drain(m, out)
    takes its head outputs (per scale, one tensor a replica) on the last
    stage. Carries go to the next stage's device by copy."""
    n_stages = plan.n_stages
    carry = {}
    for t in range(n_micro + n_stages - 1):
        for s in range(n_stages):
            m = t - s
            if not 0 <= m < n_micro:
                continue
            if s == 0:
                vals = {"x0": feed(m)}
            else:
                unpacked = [plan.unpack(b, s - 1) for b in carry.pop(m)]
                vals = {n: [u[n] for u in unpacked] for n in plan.live[s - 1]}
            vals = ops.run(vals, [STEPS[i] for i in plan.stage_steps[s]])
            if s == n_stages - 1:
                drain(m, vals["out"])
            else:
                names = plan.live[s]
                carry[m] = [plan.pack({n: vals[n][d] for n in names}, s).to(
                    row[s + 1], non_blocking=True) for d, row in enumerate(grid)]


def _layout(mesh: Mesh, pipe_axis: str, data_axis: Optional[str]):
    data_axis = resolve_data_axis(data_axis, mesh, reserved=(pipe_axis,))
    grid = mesh.grid(data_axis, pipe_axis)
    return data_axis, grid, len(grid)


def make_pp_infer_fn(model, anchors_norm, mesh: Mesh, microbatch: int,
                     num_microbatches: int, pipe_axis: str = "pipe",
                     cuts: Optional[Sequence[int]] = None,
                     image_hw: Tuple[int, int] = (640, 640),
                     strides: Tuple[int, ...] = (8, 16, 32),
                     conf_threshold: float = 0.25,
                     iou_threshold: float = 0.45,
                     max_detections: int = 300,
                     pre_nms_topk: int = 1024,
                     backend: str = "auto",
                     data_axis: Optional[str] = None) -> Callable:
    """Build ``infer(images) -> (det, valid)``: images (M*D*mb, H, W, 3)
    float, D the data axis's size (1 without one). Each micro-batch's
    detections come from ``fused_detect`` on its last stage; they are
    returned on the mesh's first device in input order, as the
    single-device pipeline gives them."""
    model = model.eval()
    data_axis, grid, n_data = _layout(mesh, pipe_axis, data_axis)
    n_micro, mb = num_microbatches, microbatch
    plan = StagePlan(model, (mb, *image_hw, 3), mesh.shape[pipe_axis], cuts)
    weights = Weights()
    anchors = {row[-1]: torch.as_tensor(anchors_norm, dtype=torch.float32,
                                        device=row[-1]) for row in grid}
    kw = dict(strides=strides, conf_threshold=conf_threshold,
              iou_threshold=iou_threshold, max_detections=max_detections,
              pre_nms_topk=pre_nms_topk, backend=backend)
    out_dev = grid[0][0]

    @torch.inference_mode()
    def pp_infer(images: torch.Tensor):
        want = n_micro * n_data * mb
        if images.shape[0] != want or tuple(images.shape[1:3]) != image_hw:
            raise ValueError(f"PP takes ({want}, {image_hw[0]}, {image_hw[1]},"
                             f" 3) images, got {tuple(images.shape)}")
        ops = ReplicaOps(model, weights, train=False)
        results = {}

        def feed(m):
            return [ops.prep(images[(m * n_data + d) * mb:
                                    (m * n_data + d + 1) * mb], row[0])
                    for d, row in enumerate(grid)]

        def drain(m, out):
            for d, row in enumerate(grid):
                det, valid = fused_detect([p[d] for p in out],
                                          anchors[row[-1]], **kw)
                results[m * n_data + d] = (det.to(out_dev, non_blocking=True),
                                           valid.to(out_dev, non_blocking=True))

        _pipeline(plan, ops, grid, n_micro, feed, drain)
        order = [results[i] for i in range(n_micro * n_data)]
        return (torch.cat([det for det, _ in order]),
                torch.cat([valid for _, valid in order]))

    return pp_infer


class PipelineTrainer(Trainer):
    """A ``Trainer`` whose ``train_step(image, labels, mask)`` takes M*D*mb
    rows, runs them through the pipeline as M micro-batches and applies
    one update (the module docstring); gradients accumulated before it
    are dropped. Images of any size a multiple of 32 train, a stage plan
    each (``image_hw``'s is made at once). The master parameters, the
    optimizer's moments and the EMA stay where the model lives (normally
    the mesh's first device); every stage copies its modules' parameters
    once a step."""

    def __init__(self, model, loss_fn, optimizer, mesh: Mesh, microbatch: int,
                 num_microbatches: int, pipe_axis: str = "pipe",
                 cuts: Optional[Sequence[int]] = None,
                 image_hw: Tuple[int, int] = (640, 640),
                 data_axis: Optional[str] = None):
        super().__init__(model, loss_fn, optimizer, num_microbatches)
        self.data_axis, self.grid, self.n_data = _layout(mesh, pipe_axis,
                                                         data_axis)
        self.mb, self.n_stages, self.cuts = (microbatch,
                                             mesh.shape[pipe_axis], cuts)
        self.plans: Dict[Tuple[int, int], StagePlan] = {}
        self.plan_for(tuple(image_hw))

    def plan_for(self, hw: Tuple[int, int]) -> StagePlan:
        """The stage plan of (H, W) images: one a shape, for multi-scale."""
        if hw not in self.plans:
            self.plans[hw] = StagePlan(self.model, (self.mb, *hw, 3),
                                       self.n_stages, self.cuts)
        return self.plans[hw]

    def train_step(self, image: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        n_micro, n_data, mb, grid = (self.accumulate, self.n_data, self.mb,
                                     self.grid)
        want = n_micro * n_data * mb
        if image.shape[0] != want:
            raise ValueError(f"the pipeline takes {n_micro} x {n_data} x {mb}"
                             f" = {want} images a step, got "
                             f"{tuple(image.shape)}")
        plan = self.plan_for(tuple(image.shape[1:3]))
        self.model.train()
        for p in self.params:
            p.grad = None
        ops = ReplicaOps(self.model, Weights(), train=True)
        master = self.params[0].device
        totals: List[torch.Tensor] = []
        parts: List[dict] = []

        def rows(m, d):
            return slice((m * n_data + d) * mb, (m * n_data + d + 1) * mb)

        def feed(m):
            return [ops.prep(image[rows(m, d)], row[0])
                    for d, row in enumerate(grid)]

        def drain(m, out):
            nums = dens = None
            for d, row in enumerate(grid):
                dev = row[-1]
                n_d, d_d = self.loss_fn.num_den(
                    [p[d] for p in out],
                    labels[rows(m, d)].to(dev, non_blocking=True),
                    mask[rows(m, d)].to(dev, non_blocking=True))
                n_d = {k: v.to(master) for k, v in n_d.items()}
                d_d = {k: v.to(master) for k, v in d_d.items()}
                if nums is None:
                    nums, dens = n_d, d_d
                else:
                    nums = {k: nums[k] + n_d[k] for k in nums}
                    dens = {k: dens[k] + d_d[k] for k in dens}
            total, p = self.loss_fn.compose(nums, dens, n_data * mb)
            totals.append(total)
            parts.append(p)

        _pipeline(plan, ops, grid, n_micro, feed, drain)
        loss = torch.stack(totals).sum()
        loss.backward()
        self.step += n_micro
        gnorm = global_norm([p.grad for p in self.params])
        self.optimizer.step(grad_norm=gnorm)
        self.optimizer.zero_grad(set_to_none=True)
        self.update_ema(self.step // n_micro)
        return {"loss": loss.detach() / n_micro, "grad_norm": gnorm,
                **{k: torch.stack([p[k] for p in parts]).detach().mean()
                   for k in parts[0]}}


def make_pp_train_step(model, loss_fn, optimizer, mesh: Mesh,
                       microbatch: int, num_microbatches: int,
                       pipe_axis: str = "pipe",
                       cuts: Optional[Sequence[int]] = None,
                       image_hw: Tuple[int, int] = (640, 640),
                       data_axis: Optional[str] = None) -> PipelineTrainer:
    """GPipe training over ``mesh``: a ``PipelineTrainer`` (the module
    docstring) whose ``train_step`` takes image (M*D*mb, H, W, 3), labels
    (M*D*mb, nb, 5) and mask (M*D*mb, nb), D the data axis's size.
    ``microbatch`` is the size a replica. Build the model with remat to
    recompute each stage's activations in the backward instead of holding
    them."""
    return PipelineTrainer(model, loss_fn, optimizer, mesh, microbatch,
                           num_microbatches, pipe_axis, cuts, image_hw,
                           data_axis)
