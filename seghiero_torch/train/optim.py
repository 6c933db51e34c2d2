"""Optimizer and learning-rate schedule (the port of
``seghiero_tpu/train/optim.py``).

``torch.optim.SGD(momentum, weight_decay, dampening=0)`` updates in the
order the JAX package's optax chain copies from it
(``add_decayed_weights`` → ``trace`` → ``scale_by_learning_rate``):
``g ← g + wd·p; buf ← μ·buf + g; p ← p − lr·buf``. ``make_schedule``
builds the optax schedules (poly / cosine / constant, with linear warmup)
as a ``LambdaLR`` multiplier of ``training.lr``, evaluated at the update
count as optax does.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from seghiero_torch.config import TrainingConfig


def _not_yet_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to seghiero_torch (ROADMAP queue 1)")


def check_optimizer_options(cfg: TrainingConfig) -> None:
    """Raise for the optimizer options the port does not have yet."""
    if cfg.optimizer != "sgd":
        raise _not_yet_ported(f"training.optimizer: {cfg.optimizer}")
    if cfg.grad_clip_norm:
        raise _not_yet_ported("training.grad_clip_norm")
    if cfg.grad_accum_steps != 1:
        raise _not_yet_ported("training.grad_accum_steps > 1")
    if cfg.backbone_lr_scale != 1.0:
        raise _not_yet_ported("training.backbone_lr_scale != 1")
    if cfg.wd_skip_norm_bias:
        raise _not_yet_ported("training.wd_skip_norm_bias")
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


def make_optimizer(cfg: TrainingConfig, params) -> torch.optim.SGD:
    check_optimizer_options(cfg)
    return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                           weight_decay=cfg.weight_decay, dampening=0.0, nesterov=False)


def make_schedule(cfg: TrainingConfig, total_steps: int, optimizer):
    """A ``LambdaLR`` stepping once per update, or None for a fixed lr."""
    fn = schedule_fn(cfg, total_steps)
    if fn is None:
        return None
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda count: fn(count) / cfg.lr)
