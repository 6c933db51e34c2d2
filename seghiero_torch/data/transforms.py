"""Joint image/mask transforms on the host (the port's own copy of
``seghiero_tpu/data/transforms.py``): resize, scale-and-crop, horizontal
flip and colour jitter, NumPy/PIL or the native C++ core.

Images stay uint8 and are normalized on the card (``data/pipeline.py``
``normalize_images``). Randomness is an explicit per-sample
``numpy.random.Generator``, consumed in the order scale → flip coin →
jitter, so a sample is fixed by (seed, epoch, index) and the raw cache
(``data/cache.py``) replays the same augmentation bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
from PIL import Image

from seghiero_torch.config import TransformConfig


def resize_mask_nearest(mask: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbor mask resize with torch-interpolate index mapping
    (floor(dst·in/out)), valid for up- or down-sampling."""
    H, W = mask.shape
    h, w = size
    ys = (np.arange(h) * H) // h
    xs = (np.arange(w) * W) // w
    return mask[ys[:, None], xs[None, :]]


@dataclasses.dataclass(frozen=True)
class JointTransform:
    """backend ``pil`` reproduces the reference's PIL bilinear
    (area-filtered); ``native`` runs the C++ core (``data/native``:
    half-pixel sampling, the torch convention), which builds or raises.

    ``scale_range`` and ``color_jitter`` act only when an ``rng`` is given
    (the train split): a scale s ∈ [lo, hi] after the base resize, then a
    random crop or a bottom-right pad (image 0, mask 255) back to the base
    size; brightness, contrast and saturation moved by at most ±that
    fraction."""

    resize: Optional[Tuple[int, int]] = None  # (H, W)
    hflip_prob: float = 0.5
    backend: str = "pil"
    scale_range: Optional[Tuple[float, float]] = None
    color_jitter: float = 0.0

    def _rescale(self, arr: np.ndarray, mask: np.ndarray,
                 size: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
        if self.backend == "native":
            from seghiero_torch.data import native

            return native.resize_bilinear_u8(arr, size), native.resize_nearest_i32(mask, size)
        h, w = size
        img = Image.fromarray(arr).resize((w, h), Image.BILINEAR)
        return np.asarray(img, np.uint8), resize_mask_nearest(mask, (h, w))

    def _scale_crop(self, arr: np.ndarray, mask: np.ndarray,
                    rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        h, w = arr.shape[:2]
        lo, hi = self.scale_range
        s = float(rng.uniform(lo, hi))
        sh, sw = max(1, round(h * s)), max(1, round(w * s))
        arr, mask = self._rescale(arr, mask, (sh, sw))
        # per axis: a random crop when scaled up, a bottom-right pad when down
        if sh > h:
            y0 = int(rng.integers(0, sh - h + 1))
            arr, mask = arr[y0 : y0 + h], mask[y0 : y0 + h]
        elif sh < h:
            arr = np.pad(arr, ((0, h - sh), (0, 0), (0, 0)))
            mask = np.pad(mask, ((0, h - sh), (0, 0)), constant_values=255)
        if sw > w:
            x0 = int(rng.integers(0, sw - w + 1))
            arr, mask = arr[:, x0 : x0 + w], mask[:, x0 : x0 + w]
        elif sw < w:
            arr = np.pad(arr, ((0, 0), (0, w - sw), (0, 0)))
            mask = np.pad(mask, ((0, 0), (0, w - sw)), constant_values=255)
        return arr, mask

    def _jitter(self, arr: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        f = self.color_jitter
        brightness = float(rng.uniform(-f, f)) * 255.0
        contrast = float(rng.uniform(1 - f, 1 + f))
        saturation = float(rng.uniform(1 - f, 1 + f))
        x = arr.astype(np.float32)
        x = (x - 127.5) * contrast + 127.5 + brightness
        gray = x.mean(axis=2, keepdims=True)
        x = gray + (x - gray) * saturation
        return np.clip(x, 0.0, 255.0).astype(np.uint8)

    def apply_arrays(self, arr: np.ndarray, mask: np.ndarray,
                     rng: Optional[np.random.Generator]) -> Tuple[np.ndarray, np.ndarray]:
        """The augmentation after the base resize, on decoded arrays: what
        the raw cache re-runs each epoch. Draws from ``rng`` in the order
        of ``__call__`` (scale → flip coin → jitter)."""
        if rng is not None and self.scale_range is not None:
            arr, mask = self._scale_crop(arr, mask, rng)
        if rng is not None and self.hflip_prob > 0 and rng.random() < self.hflip_prob:
            if self.backend == "native":
                from seghiero_torch.data import native

                arr, mask = native.hflip_u8(arr), native.hflip_i32(mask)
            else:
                arr, mask = arr[:, ::-1], mask[:, ::-1]
        if rng is not None and self.color_jitter > 0:
            arr = self._jitter(arr, rng)
        return (np.ascontiguousarray(arr),
                np.ascontiguousarray(mask.astype(np.int32, copy=False)))

    def __call__(self, img: Image.Image, mask: np.ndarray,
                 rng: Optional[np.random.Generator]) -> Tuple[np.ndarray, np.ndarray]:
        """img: PIL RGB; mask: [H, W] int. Returns (uint8 HWC, int32 HW)."""
        if self.backend == "native":
            from seghiero_torch.data import native

            arr = np.asarray(img, dtype=np.uint8)
            mask = np.ascontiguousarray(mask, np.int32)
            if self.resize is not None:
                arr = native.resize_bilinear_u8(arr, self.resize)
                mask = native.resize_nearest_i32(mask, self.resize)
        else:
            if self.resize is not None:
                h, w = self.resize
                img = img.resize((w, h), Image.BILINEAR)  # PIL takes (W, H)
                mask = resize_mask_nearest(mask, (h, w))
            arr = np.asarray(img, dtype=np.uint8)
        return self.apply_arrays(arr, mask, rng)

    @classmethod
    def from_config(cls, tf: TransformConfig) -> "JointTransform":
        return cls(resize=tf.resize, hflip_prob=tf.hflip_prob, backend=tf.backend,
                   scale_range=tf.scale_range, color_jitter=tf.color_jitter)
