"""Host-side mask transforms (counterpart of the part of
``seghiero_tpu/data/transforms.py`` the server uses)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def resize_mask_nearest(mask: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbor mask resize with torch-interpolate index mapping
    (floor(dst·in/out)), valid for up- or down-sampling."""
    H, W = mask.shape
    h, w = size
    ys = (np.arange(h) * H) // h
    xs = (np.arange(w) * W) // w
    return mask[ys[:, None], xs[None, :]]
