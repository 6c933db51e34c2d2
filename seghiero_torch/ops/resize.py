"""Spatial resizing (counterpart of ``seghiero_tpu/ops/resize.py``):
bilinear for logits, nearest for label maps."""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
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


@lru_cache(maxsize=32)
def _linear_weights_bf16(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """``[n_in, n_out]`` weights of a half-pixel linear resize along one
    axis, computed in f32 as ``jax.image.resize`` computes them (triangle
    kernel, each column normalized by its sum, which makes the edge clamp),
    rounded to bf16 as it rounds them for a bf16 image, and kept on
    ``device`` as f32."""
    inv = 1.0 / (n_out / n_in)
    src = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    w = torch.clamp(1 - (src[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs(),
                    min=0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1), 0)
    w = torch.where(((src >= -0.5) & (src <= n_in - 0.5))[None, :], w, 0)
    return w.to(torch.bfloat16).to(device, torch.float32)


def resize_bilinear_bf16(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Half-pixel bilinear resize of NCHW ``x`` to ``size`` in bf16, with
    the roundings of ``jax.image.resize`` on a bf16 array (the logits'
    storage under ``training.hiera_precision: fast``): the input and the
    weights rounded to bf16; a pass along H in f32, rounded to bf16; a pass
    along W in f32, rounded to bf16. The same bits as JAX at every ratio
    (a product of two bf16 values is exact in f32, and each output sums
    two of them). Differentiable: the cotangent is rounded where JAX's
    bf16 one is."""
    if x.ndim != 4:
        raise ValueError(f"expected NCHW, got shape {tuple(x.shape)}")
    H, W = size
    wh = _linear_weights_bf16(x.shape[2], H, x.device)
    ww = _linear_weights_bf16(x.shape[3], W, x.device)
    x = x.to(torch.bfloat16).to(torch.float32)
    y = torch.einsum("bchw,hH->bcHw", x, wh).to(torch.bfloat16).to(torch.float32)
    return torch.einsum("bchw,wW->bchW", y, ww).to(torch.bfloat16)


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
