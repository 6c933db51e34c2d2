"""Hierarchy targets, the one-hot helper and the logit-space BCE forms
(the port of ``seghiero_tpu/losses/hiera.py:50-155``)."""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from seghiero_torch.hierarchy import Hierarchy


def lut_lookup(lut, idx: torch.Tensor) -> torch.Tensor:
    """``lut[idx]`` for a small static table, int32. Indices outside
    ``[0, len(lut))`` give ``lut[0]``, as the JAX package's unrolled
    compare-select chain does; callers pass in-range indices."""
    table = torch.as_tensor(np.asarray(lut, np.int32), device=idx.device)
    inside = (idx >= 0) & (idx < len(table))
    return torch.where(inside, table[idx.clamp(0, len(table) - 1).long()], table[0])


def prepare_targets_two_level(
    labels: torch.Tensor, hierarchy: Hierarchy
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fine, coarse) targets from fine labels; ignored (255) pixels stay
    255 at both levels."""
    valid = (labels >= 0) & (labels < hierarchy.n_fine)
    safe = torch.where(valid, labels, 0)
    coarse = torch.where(valid, lut_lookup(hierarchy.fine_to_coarse, safe),
                         hierarchy.ignore_index)
    return labels, coarse.to(labels.dtype)


def prepare_targets_three_level(
    labels: torch.Tensor, hierarchy: Hierarchy
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(fine, mid, high) targets, with 255 propagated and the composed
    fine → super table (``hierarchy.fine_to_super``)."""
    valid = (labels >= 0) & (labels < hierarchy.n_fine)
    safe = torch.where(valid, labels, 0)
    mid = torch.where(valid, lut_lookup(hierarchy.fine_to_coarse, safe), hierarchy.ignore_index)
    high = torch.where(valid, lut_lookup(hierarchy.fine_to_super, safe), hierarchy.ignore_index)
    return labels, mid.to(labels.dtype), high.to(labels.dtype)


def _one_hot_valid(labels: torch.Tensor, n: int, ignore_index: int, dim: int = -1):
    """(one-hot f32 with the classes along ``dim``, valid mask). Ignored
    pixels are one-hot at class 0, as in the JAX package (their
    probabilities are masked instead)."""
    void = labels == ignore_index
    safe = torch.where(void, 0, labels).unsqueeze(dim)
    shape = [1] * safe.ndim
    shape[dim] = n
    classes = torch.arange(n, device=labels.device).reshape(shape)
    return (safe == classes).to(torch.float32), ~void


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``logaddexp(x, 0)``, as ``jax.nn.softplus`` (torch's ``F.softplus``
    switches to ``x`` above a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _log_sig_eps(logit: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """log(sigmoid(logit) + eps) in logit space:
    ``logaddexp(−softplus(−logit), log eps)`` — no 1/(p+eps) in the
    backward, so saturated logits give finite gradients (DESIGN decision 3)."""
    return torch.logaddexp(-softplus(-logit), torch.full_like(logit, math.log(eps)))


def _log_one_minus_sig_eps(logit: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """log(1 − sigmoid(logit) + eps) via 1 − sigmoid(x) = sigmoid(−x)."""
    return torch.logaddexp(-softplus(logit), torch.full_like(logit, math.log(eps)))
