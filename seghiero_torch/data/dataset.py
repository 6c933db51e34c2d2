"""Dataset factory (the port of ``seghiero_tpu/data/dataset.py:109-122``):
``dataset.kind: synthetic`` is ported; file-backed datasets and the raw
cache are not yet."""

from __future__ import annotations

from seghiero_torch.config import SegHieroConfig


def build_dataset(config: SegHieroConfig, split: str, seed: int = 0):
    if split not in ("train", "val"):
        raise ValueError("split must be 'train' or 'val'")
    if config.dataset.kind == "synthetic":
        from seghiero_torch.data.synthetic import SyntheticShapesDataset

        return SyntheticShapesDataset(config, split=split, seed=seed)
    raise NotImplementedError(
        f"dataset.kind: {config.dataset.kind} (image/mask directories) is not yet "
        "ported to seghiero_torch (ROADMAP queue 1); use dataset.kind: synthetic"
    )
