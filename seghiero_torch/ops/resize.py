"""Spatial resizing (counterpart of ``seghiero_tpu/ops/resize.py``):
bilinear for logits, nearest for label maps."""

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


def half_size(hw: Tuple[int, int]) -> Tuple[int, int]:
    """Output size of torch ``interpolate(scale_factor=0.5)`` (floor)."""
    return (hw[0] // 2, hw[1] // 2)


def downsample_labels_nearest(labels: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbor resize of integer label maps ``[B, H, W]`` →
    ``[B, h, w]``: source index ``floor(dst · in / out)``, as torch
    ``F.interpolate(mode="nearest")`` picks it — an index gather, so the
    int labels never round-trip through floats."""
    H, W = labels.shape[-2:]
    h, w = size
    ys = (torch.arange(h, device=labels.device) * H) // h
    xs = (torch.arange(w, device=labels.device) * W) // w
    return labels[..., ys[:, None], xs[None, :]]
