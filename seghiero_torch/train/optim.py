"""Optimizer and learning-rate schedule (the port of
``seghiero_tpu/train/optim.py``).

``torch.optim.SGD(momentum, weight_decay, dampening=0)`` updates in the
order the JAX package's optax chain copies from it
(``add_decayed_weights`` → ``trace`` → ``scale_by_learning_rate``):
``g ← g + wd·p; buf ← μ·buf + g; p ← p − lr·buf``. ``make_schedule``
builds the optax schedules (poly / cosine / constant, with linear warmup)
as a ``LambdaLR`` multiplier of each parameter group's learning rate,
evaluated at the update count as optax does.

The fine-tuning options of the JAX package's optax chain:

* ``backbone_lr_scale``: the backbone's parameters form groups of their
  own at ``lr · scale`` (the schedule multiplies every group alike); at
  ``0`` they are left out of the optimizer — no update, no decay, no
  momentum, as ``optax.set_to_zero`` — and keep their bits.
* ``wd_skip_norm_bias``: weight decay on conv and linear weights only
  (flax's ``kernel`` leaves); BatchNorm affine parameters and the
  classifier's bias get none.
* ``grad_clip_norm``: ``clip_grad_global_norm_``, before weight decay and
  momentum, over every gradient.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from seghiero_torch.config import TrainingConfig


def _not_yet_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to seghiero_torch (ROADMAP queue 1)")


def check_optimizer_options(cfg: TrainingConfig) -> None:
    """Raise for the optimizer options the port does not have yet."""
    if cfg.optimizer != "sgd":
        raise _not_yet_ported(f"training.optimizer: {cfg.optimizer}")
    if cfg.grad_accum_steps != 1:
        raise _not_yet_ported("training.grad_accum_steps > 1")
    if cfg.ema_decay:
        raise _not_yet_ported("training.ema_decay (parameter EMA)")


def schedule_fn(cfg: TrainingConfig, total_steps: int) -> Optional[Callable[[int], float]]:
    """The learning rate at update ``count`` for ``training.lr_schedule``
    (None: a fixed ``training.lr``)."""
    s = cfg.lr_schedule
    if not s:
        return None
    kind = s.get("type", "poly")
    warmup = int(s.get("warmup_steps", 0))
    end_lr = float(s.get("end_lr", 0.0))
    decay_steps = max(total_steps - warmup, 1)
    lr = cfg.lr
    if kind == "poly":
        power = float(s.get("power", 0.9))

        def main(count):
            frac = 1.0 - min(max(count, 0), decay_steps) / decay_steps
            return (lr - end_lr) * frac**power + end_lr
    elif kind == "cosine":
        alpha = end_lr / lr

        def main(count):
            c = min(count, decay_steps)
            return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)
    elif kind == "constant":
        def main(count):
            return lr
    else:
        raise ValueError(f"unknown lr_schedule type {kind!r}")
    if not warmup:
        return main

    def joined(count):
        if count < warmup:
            return lr * min(max(count, 0), warmup) / warmup
        return main(count - warmup)

    return joined


def param_groups(cfg: TrainingConfig, model: nn.Module) -> List[dict]:
    """The model's parameters by learning rate and weight decay, in the
    order of ``model.parameters()`` within each group (one group when no
    fine-tuning option is set)."""
    scale = cfg.backbone_lr_scale
    backbone = {id(p) for p in model.backbone.parameters()}
    kernels = {id(m.weight) for m in model.modules() if isinstance(m, (nn.Conv2d, nn.Linear))}
    groups: Dict[Tuple[float, float], list] = {}
    for p in model.parameters():
        in_backbone = id(p) in backbone
        if in_backbone and scale == 0.0:
            continue  # frozen
        lr = cfg.lr * scale if in_backbone and scale != 1.0 else cfg.lr
        decays = not cfg.wd_skip_norm_bias or id(p) in kernels
        groups.setdefault((lr, cfg.weight_decay if decays else 0.0), []).append(p)
    return [{"params": ps, "lr": lr, "weight_decay": wd} for (lr, wd), ps in groups.items()]


def make_optimizer(cfg: TrainingConfig, model: nn.Module) -> torch.optim.SGD:
    check_optimizer_options(cfg)
    return torch.optim.SGD(param_groups(cfg, model), lr=cfg.lr, momentum=cfg.momentum,
                           weight_decay=cfg.weight_decay, dampening=0.0, nesterov=False)


def clip_grad_global_norm_(params: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm``: every gradient scaled by ``c /
    max(‖g‖, c)``, ``‖g‖`` the norm of all of them together — exactly 1
    below the limit, and no epsilon (``torch.nn.utils.clip_grad_norm_``
    adds 1e-6 to the norm). No host sync. Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, max_norm / torch.clamp(norm, min=max_norm))
    return norm


def make_schedule(cfg: TrainingConfig, total_steps: int, optimizer):
    """A ``LambdaLR`` stepping once per update (each group's learning rate
    times the schedule over ``training.lr``), or None for a fixed lr."""
    fn = schedule_fn(cfg, total_steps)
    if fn is None:
        return None
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda count: fn(count) / cfg.lr)
