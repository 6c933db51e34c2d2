"""Static class-hierarchy structures (the port's own copy of
``seghiero_tpu/hierarchy.py``; the two must stay in step, which
tests/test_torch_port_model.py checks on the shipped configs).

This module turns the YAML range-lists (``coarse_to_fine_map`` /
``super_coarse_to_coarse_map``) into dense LUTs and static bucket
structures. Everything here is plain Python / NumPy computed once at
config-load time.

Reference behavior being rebuilt (file:line cites into the original
SegHiero repository):
  - ``build_fine_to_level_map``   dataset/dataloader.py:12-34
  - ``build_fine_to_coarse_map``  train.py:52-66 (dup at infer.py:17-31)
  - ``build_hiera_index``         train.py:69-83
  - ``build_fine_to_super_map``   train.py:86-99 (dup at infer.py:34-47)

Deliberate divergence (documented): the reference's
``build_fine_to_super_map`` fills an *uninitialized* length-``n_fine``
tensor at *coarse* indices and then consumes it as a fine→high LUT
(train.py:86-99 consumed at rmi_hiera_triplet_loss.py:343-345) — entries
for fine ids ≥ n_coarse are garbage. We implement the correct semantics:
``fine_to_super = coarse_to_super[fine_to_coarse[f]]``. The literal
(buggy) behavior is available via ``build_fine_to_super_map_reference``
for bug-for-bug comparisons only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

IGNORE_INDEX = 255


def build_fine_to_level_map(map_cfg: Sequence[Sequence[int]], n: int) -> np.ndarray:
    """Turn a YAML range-list into a dense LUT of length ``n``.

    Each entry of ``map_cfg`` is ``[lbl]`` or ``[start, end]`` (inclusive).
    Entry ``i`` assigns level-index ``i`` to the listed child ids.

    Mirrors dataset/dataloader.py:12-34 exactly, including its validation:
    out-of-range labels and uncovered ids raise.
    """
    mapping = np.full(n, -1, dtype=np.int32)
    for lvl, sub in enumerate(map_cfg):
        if len(sub) == 1:
            lbl = int(sub[0])
            if not (0 <= lbl < n):
                raise ValueError(f"Label {lbl} outside [0..{n - 1}]")
            mapping[lbl] = lvl
        elif len(sub) == 2:
            start, end = int(sub[0]), int(sub[1])
            if not (0 <= start <= end < n):
                raise ValueError(f"Range [{start},{end}] invalid for n={n}")
            mapping[start : end + 1] = lvl
        else:
            raise ValueError(f"Each entry must be [lbl] or [start,end], got {sub}")
    missing = np.nonzero(mapping < 0)[0]
    if missing.size:
        raise ValueError(f"Ids not mapped: {missing.tolist()}")
    return mapping


def build_hiera_index(map_cfg: Sequence[Sequence[int]]) -> Tuple[Tuple[int, int], ...]:
    """``[[start, end+1], ...]`` per bucket — mirrors train.py:69-83.

    Only meaningful when each bucket is a contiguous range (the 2-level
    loss assumes this, hiera_triplet_loss.py:33-36).
    """
    out = []
    for sub in map_cfg:
        if len(sub) == 1:
            lbl = int(sub[0])
            out.append((lbl, lbl + 1))
        else:
            out.append((int(sub[0]), int(sub[1]) + 1))
    return tuple(out)


def build_fine_to_super_map_reference(
    super_to_coarse_cfg: Sequence[Sequence[int]], n_fine: int
) -> np.ndarray:
    """Bug-for-bug replica of train.py:86-99 (see module docstring).

    Fills only the coarse-id positions; everything else is left as -1
    (the reference leaves it *uninitialized* — ``torch.empty``).
    """
    mapping = np.full(n_fine, -1, dtype=np.int32)
    for super_idx, sub in enumerate(super_to_coarse_cfg):
        if len(sub) == 1:
            mapping[int(sub[0])] = super_idx
        else:
            start, end = int(sub[0]), int(sub[1])
            mapping[start : end + 1] = super_idx
    return mapping


def _ranges_cover_contiguously(map_cfg: Sequence[Sequence[int]], n: int) -> bool:
    """True when the buckets are exactly the contiguous partition of [0, n)."""
    seen = np.full(n, -1, dtype=np.int32)
    for lvl, sub in enumerate(map_cfg):
        if len(sub) == 1:
            seen[int(sub[0])] = lvl
        else:
            seen[int(sub[0]) : int(sub[1]) + 1] = lvl
    if (seen < 0).any():
        return False
    # contiguous: each bucket's ids form one run
    return all(
        np.all(np.diff(np.nonzero(seen == lvl)[0]) == 1) for lvl in range(len(map_cfg))
    )


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    """Frozen description of a 2- or 3-level class hierarchy.

    All members are plain Python / NumPy, computed once per config.
    ``n_super == 0``
    means a 2-level (fine→coarse) hierarchy.

    Derived static structures (used by the vectorized losses):
      - ``fine_to_coarse``:  LUT [n_fine] — fine id → coarse id
      - ``coarse_ranges``:   per-coarse ``(start, end_exclusive)`` fine-id
        ranges (``hiera_index`` of train.py:69-83); only set when buckets
        are contiguous
      - ``fine_by_coarse``:  tuple per coarse of the fine ids in it
      - ``coarse_to_super``: LUT [n_coarse] (3-level only)
      - ``fine_to_super``:   LUT [n_fine] = coarse_to_super∘fine_to_coarse
      - ``coarse_by_super``: tuple per super of the coarse ids in it
    """

    n_fine: int
    n_coarse: int
    n_super: int
    fine_to_coarse: np.ndarray
    fine_by_coarse: Tuple[Tuple[int, ...], ...]
    coarse_ranges: Optional[Tuple[Tuple[int, int], ...]]
    coarse_to_super: Optional[np.ndarray] = None
    fine_to_super: Optional[np.ndarray] = None
    coarse_by_super: Optional[Tuple[Tuple[int, ...], ...]] = None
    ignore_index: int = IGNORE_INDEX

    # ------------------------------------------------------------------
    @property
    def has_super(self) -> bool:
        return self.n_super > 0

    @property
    def num_levels(self) -> int:
        return 3 if self.has_super else 2

    @property
    def total_classes(self) -> int:
        """Channel count of the segmentation logits (train.py:146-149)."""
        return self.n_fine + self.n_coarse + self.n_super

    @property
    def level_slices(self) -> Tuple[Tuple[int, int], ...]:
        """(start, stop) channel slices for each level, fine first."""
        out = [(0, self.n_fine), (self.n_fine, self.n_fine + self.n_coarse)]
        if self.has_super:
            out.append(
                (self.n_fine + self.n_coarse, self.n_fine + self.n_coarse + self.n_super)
            )
        return tuple(out)

    # ------------------------------------------------------------------
    @classmethod
    def from_class_config(cls, classes_cfg: dict) -> "Hierarchy":
        """Build from the ``classes:`` section of a SegHiero YAML config.

        Schema (example-config.yaml:9-29): ``fine_names`` /
        ``coarse_names`` dicts, ``coarse_to_fine_map`` range-list, and
        optionally ``super_coarse_names`` + ``super_coarse_to_coarse_map``.
        Presence of ``super_coarse_names`` selects the 3-level path,
        mirroring train.py:142.
        """
        n_fine = len(classes_cfg["fine_names"])
        coarse_cfg = classes_cfg["coarse_to_fine_map"]
        fine_to_coarse = build_fine_to_level_map(coarse_cfg, n_fine)
        n_coarse = int(fine_to_coarse.max()) + 1
        if "coarse_names" in classes_cfg and len(classes_cfg["coarse_names"]) != n_coarse:
            raise ValueError(
                f"coarse_names has {len(classes_cfg['coarse_names'])} entries but "
                f"coarse_to_fine_map defines {n_coarse} buckets"
            )

        fine_by_coarse = tuple(
            tuple(int(f) for f in np.nonzero(fine_to_coarse == c)[0])
            for c in range(n_coarse)
        )
        coarse_ranges = (
            build_hiera_index(coarse_cfg)
            if _ranges_cover_contiguously(coarse_cfg, n_fine)
            else None
        )

        has_super = "super_coarse_names" in classes_cfg
        if not has_super:
            return cls(
                n_fine=n_fine,
                n_coarse=n_coarse,
                n_super=0,
                fine_to_coarse=fine_to_coarse,
                fine_by_coarse=fine_by_coarse,
                coarse_ranges=coarse_ranges,
            )

        super_cfg = classes_cfg["super_coarse_to_coarse_map"]
        coarse_to_super = build_fine_to_level_map(super_cfg, n_coarse)
        n_super = int(coarse_to_super.max()) + 1
        if len(classes_cfg["super_coarse_names"]) != n_super:
            raise ValueError(
                f"super_coarse_names has {len(classes_cfg['super_coarse_names'])} "
                f"entries but super_coarse_to_coarse_map defines {n_super} buckets"
            )
        fine_to_super = coarse_to_super[fine_to_coarse]
        coarse_by_super = tuple(
            tuple(int(c) for c in np.nonzero(coarse_to_super == s)[0])
            for s in range(n_super)
        )
        return cls(
            n_fine=n_fine,
            n_coarse=n_coarse,
            n_super=n_super,
            fine_to_coarse=fine_to_coarse,
            fine_by_coarse=fine_by_coarse,
            coarse_ranges=coarse_ranges,
            coarse_to_super=coarse_to_super,
            fine_to_super=fine_to_super,
            coarse_by_super=coarse_by_super,
        )

    # ------------------------------------------------------------------
    def map_fine_labels(self, fine: np.ndarray, level: str) -> np.ndarray:
        """255-safe LUT application: fine labels → ``level`` labels.

        Fixes reference sharp edge #2 (dataloader.py:166,175 indexes a
        length-n_fine LUT with masks containing 255 → IndexError).
        ``ignore_index`` pixels stay ``ignore_index``.
        """
        if level == "fine":
            return fine
        lut = {"coarse": self.fine_to_coarse, "super": self.fine_to_super}[level]
        if lut is None:
            raise ValueError(f"hierarchy has no '{level}' level")
        valid = (fine >= 0) & (fine < self.n_fine)
        safe = np.where(valid, fine, 0)
        return np.where(valid, lut[safe], self.ignore_index).astype(fine.dtype)

    def split_upper_lower(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Derive triplet pos/neg fine-id groups from the actual hierarchy.

        The reference hardcodes ``upper_ids``/``lower_ids`` by ``n_fine>15``
        (rmi_hiera_triplet_loss.py:263-270 — Cityscapes-19 vs toy split),
        ignoring the user's YAML. We instead group non-background fine ids
        by their *super* bucket when 3-level (else by coarse bucket),
        splitting on the first bucket boundary — the semantic intent of the
        hardcoded lists.
        """
        lut = self.fine_to_super if self.has_super else self.fine_to_coarse
        ids = [f for f in range(self.n_fine) if f != 0]
        if not ids:
            return (), ()
        first_bucket = lut[ids[0]]
        upper = tuple(f for f in ids if lut[f] == first_bucket)
        lower = tuple(f for f in ids if lut[f] != first_bucket)
        return upper, lower
