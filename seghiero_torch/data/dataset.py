"""Datasets from image and mask files, and the dataset factory (the port's
own copy of ``seghiero_tpu/data/dataset.py``).

``HieroDataset`` pairs the files that an image and a mask directory have
in common by name, decodes an RGB image and an integer fine mask, derives
the coarse (and super) masks through the hierarchy's LUTs and applies the
joint transform. The fixes of the JAX package stay folded in: 255-safe
LUTs, the super level read from ``super_coarse_to_coarse_map``, fine →
super derived through coarse (``hierarchy.py``).

Samples are dicts of ``image`` uint8 [H, W, 3] and ``fine`` / ``coarse``
(/ ``super``) int32 [H, W], fixed by (seed, epoch, index).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
from PIL import Image

from seghiero_torch.config import SegHieroConfig
from seghiero_torch.data.transforms import JointTransform
from seghiero_torch.hierarchy import Hierarchy


def read_pair(img_path: str, msk_path: str):
    """The decoded RGB image (PIL) and the fine mask (int64 [H, W]; a
    mask that decodes to channels gives its first)."""
    img = Image.open(img_path).convert("RGB")
    fine = np.asarray(Image.open(msk_path), dtype=np.int64)
    if fine.ndim == 3:
        fine = fine[..., 0]
    return img, fine


class HieroDataset:
    def __init__(self, config: SegHieroConfig, split: str = "train",
                 transform: Optional[JointTransform] = None, seed: int = 0,
                 include_levels: bool = True):
        if split not in ("train", "val"):
            raise ValueError("split must be 'train' or 'val'")
        self.split = split
        self.hierarchy: Hierarchy = config.hierarchy
        self.seed = seed
        self.epoch = 0
        # the train step derives its targets from the fine mask on the
        # card, so the trainer's train set skips the level masks; eval
        # keeps them for its metrics
        self.include_levels = include_levels

        img_dir = config.dataset.image_dir(split)
        msk_dir = config.dataset.mask_dir(split)
        common = sorted(set(os.listdir(img_dir)) & set(os.listdir(msk_dir)))
        if not common:
            raise FileNotFoundError(f"No matching files between {img_dir} and {msk_dir}")
        self.img_paths = [os.path.join(img_dir, f) for f in common]
        self.msk_paths = [os.path.join(msk_dir, f) for f in common]

        if transform is not None:
            self.transform = transform
        else:
            self.transform = JointTransform.from_config(config.transform)
            # val: a deterministic evaluation; device_hflip: the train step
            # flips on the card (train/steps.py), so the host must not
            if split == "val" or config.transform.device_hflip:
                self.transform = dataclasses.replace(self.transform, hflip_prob=0.0)

    def set_epoch(self, epoch: int) -> None:
        """Advance the per-epoch augmentation stream."""
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.img_paths)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img, fine = read_pair(self.img_paths[idx], self.msk_paths[idx])
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch, idx]))
        image, fine = self.transform(img, fine, rng if self.split == "train" else None)
        out = {"image": image, "fine": fine}
        if self.include_levels:
            h = self.hierarchy
            out["coarse"] = h.map_fine_labels(fine, "coarse")
            if h.has_super:
                out["super"] = h.map_fine_labels(fine, "super")
        return out


def build_dataset(config: SegHieroConfig, split: str, seed: int = 0,
                  include_levels: bool = True, verbose: bool = True):
    """The dataset of ``dataset.kind``: synthetic shapes, or image and mask
    files — wrapped in the decode-once memmap cache under ``dataset.cache:
    raw`` (``data/cache.py``)."""
    if split not in ("train", "val"):
        raise ValueError("split must be 'train' or 'val'")
    if config.dataset.kind == "synthetic":
        from seghiero_torch.data.synthetic import SyntheticShapesDataset

        return SyntheticShapesDataset(config, split=split, seed=seed)
    ds = HieroDataset(config, split=split, seed=seed, include_levels=include_levels)
    if config.dataset.cache == "raw":
        from seghiero_torch.data.cache import RawCacheDataset

        return RawCacheDataset(ds, cache_dir=config.dataset.cache_dir,
                               include_levels=include_levels, verbose=verbose)
    return ds
