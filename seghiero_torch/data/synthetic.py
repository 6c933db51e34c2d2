"""Synthetic colored-shapes dataset (no disk, fully deterministic) — the
port's own copy of ``seghiero_tpu/data/synthetic.py``: the same numpy
generators in the same order, so the same seed gives the same arrays.

Each sample paints axis-aligned rectangles and circles of random fine
classes over a background of fine class 0; the image is a per-class base
color plus noise, and ~2 % of pixels are set to ignore (255).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from seghiero_torch.config import SegHieroConfig
from seghiero_torch.hierarchy import Hierarchy


class SyntheticShapesDataset:
    def __init__(self, config: SegHieroConfig, split: str = "train", seed: int = 0,
                 size: int | None = None, image_hw=None, ignore_fraction: float = 0.02):
        self.hierarchy: Hierarchy = config.hierarchy
        self.split = split
        self.seed = seed + (1000 if split == "val" else 0)
        self.size = size or config.dataset.synthetic_size
        self.image_hw = image_hw or config.transform.resize or (64, 64)
        self.ignore_fraction = ignore_fraction
        g = np.random.default_rng(7)
        self.palette = g.integers(40, 215, size=(self.hierarchy.n_fine, 3)).astype(np.float32)

    def set_epoch(self, epoch: int) -> None:  # augmentation-free
        pass

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        h_img, w_img = self.image_hw
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, idx]))
        n_fine = self.hierarchy.n_fine

        fine = np.zeros((h_img, w_img), dtype=np.int32)
        for _ in range(rng.integers(2, 6)):
            cls = int(rng.integers(0, n_fine))
            if rng.random() < 0.5:  # rectangle
                y0, x0 = rng.integers(0, h_img // 2), rng.integers(0, w_img // 2)
                y1 = y0 + rng.integers(4, h_img // 2)
                x1 = x0 + rng.integers(4, w_img // 2)
                fine[y0:y1, x0:x1] = cls
            else:  # circle
                cy, cx = rng.integers(0, h_img), rng.integers(0, w_img)
                r = int(rng.integers(3, max(4, min(h_img, w_img) // 4)))
                yy, xx = np.ogrid[:h_img, :w_img]
                fine[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = cls

        if self.ignore_fraction > 0:
            fine = np.where(
                rng.random((h_img, w_img)) < self.ignore_fraction, 255, fine
            ).astype(np.int32)

        color = self.palette[np.where(fine == 255, 0, fine)]
        noise = rng.normal(0, 12, size=(h_img, w_img, 3))
        image = np.clip(color + noise, 0, 255).astype(np.uint8)

        h = self.hierarchy
        out = {"image": image, "fine": fine, "coarse": h.map_fine_labels(fine, "coarse")}
        if h.has_super:
            out["super"] = h.map_fine_labels(fine, "super")
        return out
