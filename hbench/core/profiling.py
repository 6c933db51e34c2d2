"""One traced segment: torch.profiler (CPU and CUDA activity) around a
call, read into the device's busy time (the union of kernel, copy and
set intervals), the longest idle gaps labelled by the harness span and
the innermost operator the host was in, and device time by name."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

SEGMENT = "hbench::segment"


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: List[Tuple[float, float]], start: float, end: float):
    """Idle intervals of ``[start, end]`` outside the merged ``busy`` ones."""
    out, t = [], start
    for s, e in busy:
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]


def _innermost(cpu, t: float, harness: bool):
    """The shortest CPU range holding ``t``: a harness span (``harness``)
    or an operator of the program or of PyTorch."""
    best = None
    for name, s, e in cpu:
        if s <= t <= e and name.startswith("hbench::") == harness and name != SEGMENT \
                and (best is None or e - s < best[2] - best[1]):
            best = (name, s, e)
    return best[0] if best else None


def read(device, cpu, start: float, end: float, top: int = 10) -> Dict:
    """``device``, ``cpu``: ``(name, start_us, end_us)``; the segment is
    ``[start, end]`` (µs). Returns ``busy_s``, ``window_s``, device seconds
    by name, and the breakdown's two lists."""
    inside = [(n, max(s, start), min(e, end)) for n, s, e in device if e > start and s < end]
    busy = merge([(s, e) for _, s, e in inside])
    by_name: Dict[str, float] = defaultdict(float)
    for n, s, e in inside:
        by_name[n] += (e - s) * 1e-6
    idle = sorted(gaps(busy, start, end), key=lambda g: g[0] - g[1])[:top]
    labelled = []
    for s, e in idle:
        mid = 0.5 * (s + e)
        span = _innermost(cpu, mid, True)
        op = _innermost(cpu, mid, False)
        label = span[len("hbench::"):] if span else "between spans"
        labelled.append([f"{label}/{op}" if op else label, (e - s) * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": sum(e - s for s, e in busy) * 1e-6, "window_s": (end - start) * 1e-6,
            "device_seconds": dict(by_name),
            "breakdown": {"device_ops": [[n, v] for n, v in ops], "idle_gaps": labelled}}


def segment(fn: Callable[[], None], spans) -> Dict:
    """Profile ``fn()`` and a synchronize after it; see ``read``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    spans.profiling = True
    try:
        with profile(activities=[ProfilerActivity.CPU]
                     + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
            t0 = time.perf_counter()
            with record_function(SEGMENT):
                fn()
                sync()
            host_s = time.perf_counter() - t0
    finally:
        spans.profiling = False
    device, cpu, seg = [], [], None
    for e in prof.events():
        r = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type != DeviceType.CUDA:
            cpu.append(r)
            if e.name == SEGMENT:
                seg = r
        elif not getattr(e, "is_user_annotation", False):
            device.append(r)
    # a range recorded on the host (``record_function``: the harness's
    # spans, the optimizer's) is mirrored on the device's timeline under
    # its own name: an annotation, not device work
    host_names = {name for name, _, _ in cpu}
    device = [r for r in device if r[0] not in host_names]
    if seg is None:
        raise RuntimeError("the profiler's trace lost the segment's range")
    out = read(device, cpu, seg[1], seg[2])
    out["host_s"] = host_s
    out["device_events"] = len(device)
    return out
