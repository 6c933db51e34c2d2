"""AdamW as ``optax.adamw`` (and ``torch.optim.AdamW``) updates: ``m ← β₁m
+ (1−β₁)g``, ``v ← β₂v + (1−β₂)g²``, ``p ← p − lr_t·(m̂/(√v̂ + ε) + wd·p)``
with ``m̂ = m/(1−β₁ᵗ)``, ``v̂ = v/(1−β₂ᵗ)``, ``t`` the update's count from
1 and ε 1e-8; each parameter at its ``param_setting``, ``lr_t`` that times
the schedule of ``training.lr_schedule`` at the update's index (a linear
warm-up from 0, then poly, cosine or constant), as the program's
``LambdaLR`` gives it."""

from __future__ import annotations

import math
from typing import Dict

import torch

from hbench.reference.train import param_setting

EPS = 1e-8
# the training driver's horizon: it builds the program's schedule over
# this many steps (``core/trainlib.py``)
TOTAL_STEPS = 10**9


def schedule(training: Dict, step: int) -> float:
    """The learning rate's factor at update ``step`` (from 0)."""
    s = training.get("lr_schedule")
    if not s:
        return 1.0
    warmup = int(s.get("warmup_steps", 0))
    if step < warmup:
        return step / warmup
    lr = float(training.get("lr", 1e-3))
    end = float(s.get("end_lr", 0.0)) / lr
    decay = max(TOTAL_STEPS - warmup, 1)
    c = min(step - warmup, decay)
    kind = s.get("type", "poly")
    if kind == "poly":
        return (1.0 - end) * (1.0 - c / decay) ** float(s.get("power", 0.9)) + end
    if kind == "cosine":
        return (1.0 - end) * 0.5 * (1.0 + math.cos(math.pi * c / decay)) + end
    if kind == "constant":
        return 1.0
    raise ValueError(f"unknown lr_schedule type {kind!r}")


def update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: Dict,
           training: Dict, step: int) -> None:
    """One step on ``params`` in place (under ``no_grad``), ``state``
    holding each parameter's two moments by name."""
    b1 = float(training.get("adam_beta1", 0.9))
    b2 = float(training.get("adam_beta2", 0.999))
    factor, t = schedule(training, step), step + 1
    for k, p in params.items():
        lr, wd = param_setting(k, p, training)
        g = grads[k]
        m, v = state.setdefault(k, (torch.zeros_like(p), torch.zeros_like(p)))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        step_dir = (m / (1 - b1**t)) / ((v / (1 - b2**t)).sqrt() + EPS)
        p -= lr * factor * (step_dir + wd * p)
