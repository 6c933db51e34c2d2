"""SGD with momentum, as ``torch.optim.SGD(momentum, weight_decay,
dampening=0)`` updates: ``d ← g + wd·p; buf ← d`` at the first step,
``buf ← μ·buf + d`` after; ``p ← p − lr·buf``, each parameter at its
``param_setting``."""

from __future__ import annotations

from typing import Dict

import torch

from hbench.reference.train import param_setting


def update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: Dict,
           training: Dict, step: int) -> None:
    """One step on ``params`` in place (under ``no_grad``), ``state``
    holding each parameter's momentum buffer by name."""
    mom = float(training.get("momentum", 0.9))
    for k, p in params.items():
        lr, wd = param_setting(k, p, training)
        d = grads[k] + wd * p
        state[k] = d if step == 0 else mom * state[k] + d
        p -= lr * state[k]
