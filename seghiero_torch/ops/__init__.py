"""The port's hand-written kernels and their plain PyTorch versions.

Each module below counts its launches in plain-int module attributes and
lists them, once, in its ``COUNTERS``. This package is the one place that
knows the whole set: ``counters`` and ``launch_counts`` read every counter,
and ``add_launches`` advances them — a CUDA graph's replay runs no Python,
so whoever replays a capture adds what the capture counted
(``train/steps.py``).
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict, Tuple

from seghiero_torch.ops import attention, depthwise, hiera2_fused, rmi_gram, upsample_argmax

COUNTED = (attention, depthwise, hiera2_fused, rmi_gram, upsample_argmax)


def counters() -> Dict[Tuple[ModuleType, str], int]:
    """Every launch counter's value, keyed ``(module, attribute)``."""
    return {(m, a): getattr(m, a) for m in COUNTED for a in m.COUNTERS}


def launch_counts() -> Dict[str, int]:
    """Every launch counter's value, keyed ``"<module>.<attr>"`` (e.g.
    ``"seghiero_torch.ops.depthwise.launches"``)."""
    return {f"{m.__name__}.{a}": n for (m, a), n in counters().items()}


def add_launches(delta: Dict[Tuple[ModuleType, str], int]) -> None:
    """Advance each counter of ``delta`` (keys as ``counters``'s) by its
    value."""
    for (m, a), n in delta.items():
        setattr(m, a, getattr(m, a) + n)
