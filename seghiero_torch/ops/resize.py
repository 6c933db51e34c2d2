"""Bilinear resize (counterpart of ``seghiero_tpu/ops/resize.py``)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Half-pixel bilinear resize of NCHW ``x`` to spatial ``size`` = (H, W)
    — the ``jax.image.resize(method="linear", antialias=False)``
    convention, for up- and down-sampling."""
    if x.ndim != 4:
        raise ValueError(f"expected NCHW, got shape {tuple(x.shape)}")
    return F.interpolate(
        x, size=tuple(size), mode="bilinear", align_corners=False, antialias=False
    )
