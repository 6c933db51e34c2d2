"""Optimizer and learning-rate schedule (the port of
``seghiero_tpu/train/optim.py``).

``training.optimizer: sgd`` is ``torch.optim.SGD(momentum, weight_decay,
dampening=0)``, which updates in the order the JAX package's optax chain
copies from it (``add_decayed_weights`` → ``trace`` →
``scale_by_learning_rate``): ``g ← g + wd·p; buf ← μ·buf + g; p ← p −
lr·buf``. ``adamw`` is ``torch.optim.AdamW(betas=(adam_beta1,
adam_beta2), eps=1e-8)``, ``optax.adamw``'s update: ``p ← p − lr·(m̂ /
(√v̂ + eps) + wd·p)``, the decay decoupled from the moments. ``make_schedule``
builds the optax schedules (poly / cosine / constant, with linear warmup)
as a ``LambdaLR`` multiplier of each parameter group's learning rate,
evaluated at the update count as optax does.

The fine-tuning options of the JAX package's optax chain:

* ``backbone_lr_scale``: the backbone's parameters form groups of their
  own at ``lr · scale`` (the schedule multiplies every group alike); at
  ``0`` they are left out of the optimizer — no update, no decay, no
  momentum or moments, as ``optax.set_to_zero`` — and keep their bits.
* ``wd_skip_norm_bias``: weight decay on conv, deconvolution and linear
  weights only (flax's ``kernel`` leaves, ``_wd_mask``); BatchNorm and
  LayerNorm affine parameters, every bias and ViT's CLS, register and
  position tokens get none.
* ``grad_clip_norm``: ``clip_grad_global_norm_``, before weight decay and
  the optimizer's update, over every gradient.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from seghiero_torch.config import TrainingConfig, not_yet_ported


def check_optimizer_options(cfg: TrainingConfig) -> None:
    """Raise for the optimizer options the port does not have yet."""
    if cfg.grad_accum_steps != 1:
        raise not_yet_ported("training.grad_accum_steps > 1")
    if cfg.ema_decay:
        raise not_yet_ported("training.ema_decay (parameter EMA)")


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
    kernels = {id(m.weight) for m in model.modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))}
    groups: Dict[Tuple[float, float], list] = {}
    for p in model.parameters():
        in_backbone = id(p) in backbone
        if in_backbone and scale == 0.0:
            continue  # frozen
        lr = cfg.lr * scale if in_backbone and scale != 1.0 else cfg.lr
        decays = not cfg.wd_skip_norm_bias or id(p) in kernels
        groups.setdefault((lr, cfg.weight_decay if decays else 0.0), []).append(p)
    return [{"params": ps, "lr": lr, "weight_decay": wd} for (lr, wd), ps in groups.items()]


# the update's implementation flags: how it is computed on the parameters'
# device, not what it computes (``load_optimizer_state`` keeps them)
IMPLEMENTATION = ("foreach", "fused", "capturable")


def make_optimizer(cfg: TrainingConfig, model: nn.Module) -> torch.optim.Optimizer:
    """The optimizer of ``training.optimizer`` over ``param_groups``. With
    every parameter on the card it is the form that reads a learning rate
    from a device tensor and keeps its state there, so the train step needs
    no host sync and can run as one CUDA graph (``train/steps.py``): SGD's
    fused update, AdamW's ``capturable`` one (the step count on the card).
    Elsewhere, the default (foreach) forms."""
    check_optimizer_options(cfg)
    groups = param_groups(cfg, model)
    params = [p for g in groups for p in g["params"]]
    on_card = bool(params) and all(p.is_cuda for p in params)
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(groups, lr=cfg.lr, betas=(cfg.adam_beta1, cfg.adam_beta2),
                                 eps=1e-8, weight_decay=cfg.weight_decay, capturable=on_card)
    return torch.optim.SGD(groups, lr=cfg.lr, momentum=cfg.momentum,
                           weight_decay=cfg.weight_decay, dampening=0.0, nesterov=False,
                           fused=on_card or None)


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: Dict) -> None:
    """``optimizer.load_state_dict(state)``, keeping the optimizer's own
    ``IMPLEMENTATION`` flags: a state saved by a run on another device (or
    by an older version of this module) resumes with the update this
    optimizer was built to run here."""
    groups = [dict(saved, **{k: g[k] for k in IMPLEMENTATION if k in g})
              for saved, g in zip(state["param_groups"], optimizer.param_groups)]
    # the flags go in before the load, which places each state value by them
    # (AdamW's step count on the card only where it is capturable)
    optimizer.load_state_dict(dict(state, param_groups=groups))


def clip_grad_global_norm_(params: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm``: every gradient scaled by ``c /
    max(‖g‖, c)``, ``‖g‖`` the norm of all of them together — exactly 1
    below the limit, and no epsilon (``torch.nn.utils.clip_grad_norm_``
    adds 1e-6 to the norm). No host sync. Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, max_norm / torch.clamp(norm, min=max_norm))
    return norm


def write_lrs(optimizer: torch.optim.Optimizer, lrs: List[torch.Tensor]) -> None:
    """Each group's learning rate, the float the schedule set, into its
    0-dim f32 tensor in ``lrs``: a fill that takes the value as its
    argument, so no host sync."""
    for t, g in zip(lrs, optimizer.param_groups):
        t.fill_(g["lr"])


@contextlib.contextmanager
def device_lrs(optimizer: torch.optim.Optimizer, lrs: List[torch.Tensor]):
    """Inside, each group's learning rate is its tensor in ``lrs``, which
    the update reads on the device (SGD's fused and AdamW's capturable
    forms take it), so a captured update reads the value written before
    each replay; outside, the schedule's floats, as the optimizer's state
    and checkpoints keep them."""
    groups = optimizer.param_groups
    floats = [g["lr"] for g in groups]
    for g, t in zip(groups, lrs):
        g["lr"] = t
    try:
        yield
    finally:
        for g, f in zip(groups, floats):
            g["lr"] = f


def make_schedule(cfg: TrainingConfig, total_steps: int, optimizer):
    """A ``LambdaLR`` stepping once per update (each group's learning rate
    times the schedule over ``training.lr``), or None for a fixed lr."""
    fn = schedule_fn(cfg, total_steps)
    if fn is None:
        return None
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda count: fn(count) / cfg.lr)
