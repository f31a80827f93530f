"""Training step: forward, loss, backward, the optimizer chain and the EMA.

Port of ``yolov5m_tpu/train/trainer.py`` (its per-leaf path). The optax
chain the JAX package builds is reproduced in plain tensor code
(``torch._foreach_*`` over the parameter list), in its order:

  clip by global norm (scale by max/||g|| only when ||g|| >= max)
  -> + wd * param (coupled L2, torch Adam style)
  -> Adam(0.9, 0.999, eps 1e-8 outside the square root)
  -> * -lr(count), count = optimizer updates applied before this one.

Gradients are SUMMED over ``accumulate`` micro-batches (autograd adds
into ``.grad``) and applied when ``step % accumulate == 0``; ``grad_norm``
is the norm of the accumulated sum at every micro-batch. The EMA of the
parameters (decay 0.9999 * (1 - exp(-t/2000)), t the number of
accumulation windows) steps after every window; BN running statistics
are live buffers the forward updates. There is no GradScaler: bf16 needs
no loss scaling.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from yolov5m_tpu_torch.config import Config
from yolov5m_tpu_torch.train.loss import PARTS, YoloLoss

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
MAX_CONSECUTIVE_NONFINITE = 100


def make_lr_schedule(cfg: Config,
                     total_steps: Optional[int] = None) -> Callable[[int], float]:
    """lr as a function of the optimizer-update count (accumulation-gated
    updates, not micro-batches). "constant" is cfg.learning_rate;
    "cosine" is optax's join of a linear warmup 0 -> lr over
    cfg.warmup_steps and a cosine decay to lr * cfg.lr_final at
    total_steps. Computed in double precision (optax computes in f32)."""
    lr = cfg.learning_rate
    if cfg.lr_schedule == "constant":
        return lambda count: lr
    if cfg.lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if total_steps is None:
        raise ValueError("the cosine schedule needs total_steps")
    warmup = cfg.warmup_steps
    decay_steps = max(total_steps - warmup, 1)

    def cosine(count):
        count = min(float(count), float(decay_steps))
        decayed = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return lr * ((1 - cfg.lr_final) * decayed + cfg.lr_final)

    if warmup <= 0:
        return cosine

    def schedule(count):
        if count < warmup:        # optax.linear_schedule(0, lr, warmup)
            frac = 1 - min(max(count, 0), warmup) / warmup
            return (0.0 - lr) * frac + lr
        return cosine(count - warmup)

    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in f32 arithmetic, as optax computes it (at count 1
    f32(0.999) is 1.3e-5 off 0.999 relative to 1 - 0.999)."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


class YoloAdam(torch.optim.Optimizer):
    """The JAX package's optimizer chain (its ``make_optimizer``) as a
    torch optimizer: clip -> coupled weight decay -> Adam -> -lr(count).

    One counter, ``count`` in the parameter group, counts the updates
    applied; the lr is derived from it at each step, so a state saved
    under one schedule resumes under another at the right position (what
    the JAX package's ``upgrade_opt_state_to_schedule`` grafts by hand).

    guard_nonfinite: a step whose gradients hold NaN or inf changes no
    parameter and no moment (optax.apply_if_finite), up to
    MAX_CONSECUTIVE_NONFINITE in a row; the next one is applied."""

    def __init__(self, params, cfg: Config, total_steps: Optional[int] = None):
        super().__init__(params, {"count": 0, "notfinite": 0})
        self.schedule = make_lr_schedule(cfg, total_steps)
        self.max_grad_norm = cfg.max_grad_norm
        self.weight_decay = cfg.weight_decay
        self.guard_nonfinite = cfg.guard_nonfinite

    @torch.no_grad()
    def step(self, closure=None, grad_norm: Optional[torch.Tensor] = None):
        """Apply one update from the params' ``.grad``. Returns whether it
        was applied (False only for a skipped non-finite step)."""
        if closure is not None:
            raise ValueError("YoloAdam takes no closure")
        group = self.param_groups[0]
        params = [p for p in group["params"] if p.grad is not None]
        grads = [p.grad for p in params]
        if self.guard_nonfinite:
            finite = bool(torch.stack([g.isfinite().all() for g in grads]).all())
            group["notfinite"] = 0 if finite else group["notfinite"] + 1
            if not finite and group["notfinite"] <= MAX_CONSECUTIVE_NONFINITE:
                return False
        if grad_norm is None:
            grad_norm = global_norm(grads)
        # clip: scale by max/||g|| only when ||g|| >= max (no sync: a
        # 0-dim factor on the device)
        coef = torch.where(grad_norm < self.max_grad_norm,
                           torch.ones_like(grad_norm),
                           self.max_grad_norm / grad_norm)
        u = torch._foreach_mul(grads, coef)
        torch._foreach_add_(u, params, alpha=self.weight_decay)
        for p in params:
            st = self.state[p]
            if not st:
                st["exp_avg"] = torch.zeros_like(p)
                st["exp_avg_sq"] = torch.zeros_like(p)
        mu = [self.state[p]["exp_avg"] for p in params]
        nu = [self.state[p]["exp_avg_sq"] for p in params]
        torch._foreach_mul_(mu, ADAM_B1)
        torch._foreach_add_(mu, u, alpha=1 - ADAM_B1)
        torch._foreach_mul_(nu, ADAM_B2)
        torch._foreach_addcmul_(nu, u, u, value=1 - ADAM_B2)
        lr = self.schedule(group["count"])
        group["count"] += 1
        mu_hat = torch._foreach_div(mu, _bias_correction(ADAM_B1, group["count"]))
        denom = torch._foreach_sqrt(
            torch._foreach_div(nu, _bias_correction(ADAM_B2, group["count"])))
        torch._foreach_add_(denom, ADAM_EPS)
        torch._foreach_div_(mu_hat, denom)
        torch._foreach_add_(params, mu_hat, alpha=-lr)
        return True


def ema_decay(step: int, base: float = 0.9999, tau: float = 2000.0) -> float:
    """Ramped EMA decay: base * (1 - exp(-step / tau))."""
    return base * (1.0 - math.exp(-step / tau))


def accumulation_steps(batch_size: int, nominal: int = 64) -> int:
    """max(round(nominal / bs), 1) micro-batches per optimizer update."""
    return max(round(nominal / batch_size), 1)


class Trainer:
    """The training state (model, optimizer, EMA, micro-batch count) and
    its step. ``train_step`` runs one micro-batch; ``eval_state_dict`` is
    what the evaluator scores: the EMA parameters with the live BN
    statistics (the JAX ``TrainState.eval_params``).

    group: a torch.distributed process group makes it the data-parallel
    trainer (``parallel/dp.py``; the JAX ``pmean_axis``). Each rank runs
    its rows of the global batch through the group's global loss; after
    the backward one flat all_reduce sums the micro-batch's gradients over
    the ranks and adds them to the accumulated global gradient, so
    ``grad_norm`` and every update are those of the global batch; a second
    one averages the BN running buffers over the ranks (the JAX pmean) and
    sums the loss shares into the reported global loss. The state dicts
    hold the single-process keys.

    forward: what the step calls in place of ``model`` (images -> the
    three logits), such as the spatially or tensor-parallel forward of
    ``parallel/sp.py`` and ``tp.py`` over the same master parameters."""

    def __init__(self, model: nn.Module, loss_fn: YoloLoss,
                 optimizer: YoloAdam, accumulate: int = 1, group=None,
                 forward: Optional[Callable] = None):
        self.model, self.loss_fn, self.optimizer = model, loss_fn, optimizer
        self.forward = model if forward is None else forward
        self.accumulate = accumulate
        self.step = 0
        self.params = list(model.parameters())
        self.ema = [p.detach().clone() for p in self.params]
        self.group = group
        if group is not None:
            self.loss_fn = loss_fn.with_group(group)
            self.buffers = [b for b in model.buffers() if b.is_floating_point()]

    def train_step(self, image: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One micro-batch: (bs, H, W, 3) images, (bs, nb, 5) labels, (bs,
        nb) mask, on the model's device (under DP, this rank's rows).
        Returns detached 0-dim tensors loss, grad_norm, box, obj, cls (no
        host sync)."""
        self.model.train()
        if self.group is not None:
            total, parts = self._dp_forward_backward(image, labels, mask)
        else:
            total, parts = self.loss_fn(self.forward(image), labels, mask)
            total.backward()
        self.step += 1
        gnorm = global_norm([p.grad for p in self.params])
        if self.step % self.accumulate == 0:
            self.optimizer.step(grad_norm=gnorm)
            self.optimizer.zero_grad(set_to_none=True)
            self.update_ema(self.step // self.accumulate)
        return {"loss": total.detach(), "grad_norm": gnorm,
                **{k: v.detach() for k, v in parts.items()}}

    def _dp_forward_backward(self, image, labels, mask):
        """This rank's share through the backward, then the two flat
        collectives. Returns the global (total, parts), detached."""
        from torch._utils import (_flatten_dense_tensors,
                                  _unflatten_dense_tensors)

        accum = [p.grad for p in self.params]
        for p in self.params:
            p.grad = None                  # this micro-batch's grads alone
        total, parts = self.loss_fn(self.model(image), labels, mask)
        total.backward()
        grads = [p.grad for p in self.params]
        flat = _flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=self.group)
        # back into autograd's own tensors, whose layout (channels_last
        # convs) the norm and the optimizer then see as without DP
        torch._foreach_copy_(grads, _unflatten_dense_tensors(flat, grads))
        for p, a, g in zip(self.params, accum, grads):
            p.grad = g if a is None else a.add_(g)

        # BN running buffers to their mean, and the loss shares to their sum
        scalars = torch.stack([total.detach()]
                              + [parts[k].detach() for k in PARTS])
        flat = torch.cat([_flatten_dense_tensors(self.buffers), scalars])
        dist.all_reduce(flat, group=self.group)
        n = flat.numel() - scalars.numel()
        world = dist.get_world_size(self.group)
        with torch.no_grad():
            torch._foreach_copy_(self.buffers, _unflatten_dense_tensors(
                flat[:n] / world, self.buffers))
        total, *rest = flat[n:].unbind(0)
        return total, dict(zip(PARTS, rest))

    @torch.no_grad()
    def update_ema(self, t: int) -> None:
        d = ema_decay(t)
        torch._foreach_mul_(self.ema, d)
        torch._foreach_add_(self.ema, self.params, alpha=1.0 - d)

    @torch.no_grad()
    def reset_ema(self) -> None:
        """The EMA becomes a copy of the current parameters."""
        torch._foreach_copy_(self.ema, self.params)

    def eval_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state dict with the EMA in place of the parameters."""
        ema = {n: e for (n, _), e in zip(self.model.named_parameters(),
                                         self.ema)}
        return {k: ema.get(k, v) for k, v in self.model.state_dict().items()}

    def state_dict(self) -> dict:
        """Everything a resume needs, the accumulated gradients included."""
        return {"step": self.step,
                "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "ema": list(self.ema),
                "accum": [p.grad for p in self.params]}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        with torch.no_grad():
            torch._foreach_copy_(self.ema, list(state["ema"]))
        for p, g in zip(self.params, state["accum"]):
            p.grad = None if g is None else g.to(p.device).clone()
