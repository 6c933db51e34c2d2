"""Spans at the port's layer boundaries: host time by name, read by the
benchmark's per-layer metrics and written by ``output.profile_dir``.

    with trace.span("train.forward"):
        ...

Recording is on while a ``torch.profiler`` session runs, and only then.
Off, a span reads one flag and returns one shared no-op object, ``OFF``:
no ``record_function``, no clock, no lock. On, it reads
``time.perf_counter_ns()`` on entry and exit and adds its count, seconds
and parent span's name (the innermost open span of its thread) to
in-memory totals, under a lock, since the loader's worker thread records
too; and it enters ``record_function("seghiero::<name>")``, so the span
lies in the profiler's trace on the device's clock (the profiler traces
the thread that started it, not the loader's worker). The module keeps
no list of single spans: the profiler's trace holds those.

The totals reset when recording begins after a stretch with it off (a
span that ran while off), and a span counts only if recording is on at
its entry and its exit, so ``totals()`` holds the spans of the last
recorded stretch.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _profiler

PREFIX = "seghiero::"

_lock = threading.Lock()
_local = threading.local()
_totals: Dict[str, list] = {}  # name -> [count, ns, parent]
_stale = True  # recording was off since the totals were last reset


def _profiling() -> bool:
    """Whether a ``torch.profiler`` session runs: the flag PyTorch keeps
    for its own fast checks (``tests/test_torch_port_trace.py`` pins it)."""
    return getattr(_profiler, "_is_profiler_enabled", False)


# every span while recording is off, and a caller's that records none
OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "parent", "rf", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _stale
        if _stale:
            with _lock:
                if _stale:
                    _totals.clear()
                    _stale = False
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.rf = _profiler.record_function(PREFIX + self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        self.rf.__exit__(*exc)
        _local.stack.pop()
        if not _profiling():
            return False  # it outlived the stretch (a worker thread's): not in it
        with _lock:
            t = _totals.setdefault(self.name, [0, 0, self.parent])
            t[0] += 1
            t[1] += ns
        return False


def span(name: str):
    """A context manager timing ``name`` while recording is on."""
    global _stale
    if not _profiling():
        _stale = True
        return OFF
    return _Span(name)


def totals() -> Dict[str, Dict]:
    """``{name: {"count", "seconds", "parent"}}`` of the last recorded
    stretch; ``parent`` is the enclosing span's name, or None."""
    with _lock:
        return {k: {"count": n, "seconds": ns * 1e-9, "parent": p}
                for k, (n, ns, p) in _totals.items()}


class StepProfiler:
    """``output.profile_dir``'s exporter: call ``step()`` before each of a
    loop's units (steps, batches; counted from 1) and ``close()`` after the
    loop. Units ``first`` to ``last`` run under ``torch.profiler`` (CPU,
    and CUDA where there is a card); then ``out_dir`` gets ``trace.json``
    (a Chrome trace: the ``seghiero::`` ranges beside the kernels) and
    ``spans.json`` (``totals()`` over those units). With no ``out_dir``
    it does nothing."""

    def __init__(self, out_dir: Optional[str], first: int, last: int):
        self.out_dir, self.first, self.last = out_dir, first, last
        self.n = 0
        self._prof = None

    def step(self) -> None:
        self.n += 1
        if not self.out_dir:
            return
        if self.n == self.first:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        elif self.n == self.last + 1:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.out_dir, "trace.json"))
        with open(os.path.join(self.out_dir, "spans.json"), "w") as f:
            json.dump(totals(), f, indent=1, sort_keys=True)

