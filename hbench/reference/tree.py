"""The label tree of a configuration, read from its ``classes`` section:
``coarse_to_fine_map`` (and, for three levels,
``super_coarse_to_coarse_map``), each entry ``[id]`` or an inclusive
``[start, end]`` range of child ids."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

IGNORE = 255


def _lut(entries, n_children: int) -> List[int]:
    lut = [-1] * n_children
    for parent, e in enumerate(entries):
        lo, hi = (e[0], e[0]) if len(e) == 1 else (e[0], e[1])
        for c in range(lo, hi + 1):
            lut[c] = parent
    if min(lut) < 0:
        raise ValueError(f"ids not covered by {entries}")
    return lut


@dataclass(frozen=True)
class Tree:
    n_fine: int
    n_coarse: int
    n_super: int  # 0 for two levels
    fine_to_coarse: Tuple[int, ...]
    coarse_to_super: Optional[Tuple[int, ...]]

    @property
    def levels(self) -> Dict[str, Tuple[int, int]]:
        """Channel slices of each level in the logits: fine | coarse | super."""
        out = {"fine": (0, self.n_fine),
               "coarse": (self.n_fine, self.n_fine + self.n_coarse)}
        if self.n_super:
            out["super"] = (self.n_fine + self.n_coarse, self.total)
        return out

    @property
    def total(self) -> int:
        return self.n_fine + self.n_coarse + self.n_super

    @property
    def fine_to_super(self) -> Tuple[int, ...]:
        return tuple(self.coarse_to_super[c] for c in self.fine_to_coarse)

    def children(self, lut) -> List[List[int]]:
        out: List[List[int]] = [[] for _ in range(max(lut) + 1)]
        for child, parent in enumerate(lut):
            out[parent].append(child)
        return out


def from_classes(classes: Dict) -> Tree:
    c2f = classes["coarse_to_fine_map"]
    n_fine = 1 + max(e[-1] for e in c2f)
    f2c = _lut(c2f, n_fine)
    s2c = classes.get("super_coarse_to_coarse_map")
    c2s = _lut(s2c, len(c2f)) if s2c else None
    return Tree(n_fine, len(c2f), len(s2c) if s2c else 0, tuple(f2c),
                tuple(c2s) if c2s else None)
