"""The program's kernels against their least time, in a traced segment.

Each ``kernels/<name>.py`` names the program's launch counter
(``COUNTER``: module and attribute), the device function names its
launches run under (``NAMES``), and ``launches(unit)``: the work
(``bytes``, ``flops``, ``flops_per_s``, ``mufu``) of each of its launches
in one step or batch of the segment's geometry (``core/geometry.py``).
The least time of the segment's launches over the device time of every
kernel with those names is the roofline share."""

from __future__ import annotations

import importlib
from collections import defaultdict
from typing import Dict

from hbench.core import peaks


def read_counters(kernels) -> Dict[str, int]:
    """The program's launch counters of ``kernels`` (``Bench.kernels()``)."""
    out = {}
    for name, mod in kernels.items():
        module, attr = mod.COUNTER
        out[name] = int(getattr(importlib.import_module(module), attr, 0))
    return out


def launch_seconds(work: Dict) -> float:
    return peaks.least_seconds(work.get("bytes", 0.0), work.get("flops", 0.0),
                               work.get("flops_per_s", peaks.F32_FLOPS), work.get("mufu", 0.0))


def shares(trace: Dict, kernels) -> Dict[str, Dict]:
    """Per group of kernels sharing device names: launches, least seconds,
    device seconds and the share (%), over the segment ``trace`` (with
    ``launches`` by kernel, ``geos`` per unit and ``device_seconds`` by
    device name). Empty when no counted kernel ran."""
    groups: Dict[tuple, Dict] = defaultdict(lambda: {"kernels": [], "launches": 0,
                                                     "least_s": 0.0})
    for name, mod in kernels.items():
        n = trace["launches"].get(name, 0)
        if n <= 0:
            continue
        per_unit = [mod.launches(g) for g in trace["geos"]]
        works = [w for unit in per_unit for w in unit]
        if not works:
            continue
        least = sum(launch_seconds(w) for w in works)
        if len(works) != n:  # launches the geometry did not foresee: their mean each
            least *= n / len(works)
        g = groups[tuple(mod.NAMES)]
        g["kernels"].append(name)
        g["launches"] += n
        g["least_s"] += least
    out = {}
    for names, g in groups.items():
        dev = sum(s for dn, s in trace["device_seconds"].items() if any(k in dn for k in names))
        if dev > 0:
            out["+".join(g["kernels"])] = dict(g, device_s=dev, share=100.0 * g["least_s"] / dev)
    return out


def roofline(trace: Dict, kernels):
    """Σ least time ÷ Σ device time of the program's kernels (%), or None."""
    s = shares(trace, kernels)
    dev = sum(v["device_s"] for v in s.values())
    if not s or dev <= 0:
        return None
    return 100.0 * sum(v["least_s"] for v in s.values()) / dev
