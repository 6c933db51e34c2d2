"""One run of one cell: set-up, the measured window, optionally a traced
segment, the program's state freed, then the reference's check.

``run_cell`` is what ``hbench/run.py`` calls on the card; the CPU tests
call it with ``device="cpu"`` and tiny overrides (the rehearsal), and
``hbench/calibrate.py`` with a ``control``.
"""

from __future__ import annotations

import copy
import gc
import math
import time
from dataclasses import dataclass, field
from types import ModuleType
from typing import Dict, Optional

import torch

from hbench.core import kernelwork, profiling, spec
from hbench.core.spans import Spans
from hbench.reference.tree import Tree, from_classes


def merge(base: Dict, patch: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in (patch or {}).items():
        out[k] = merge(out.get(k, {}), v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else copy.deepcopy(v)
    return out


@dataclass
class Ctx:
    """What a driver is given: the cell, its configuration and traffic, the
    configuration's reference module (``reference``, from its
    ``reference`` entry), the bench (``bench.optimizer``), and whether the
    run traces a segment (``trace``)."""

    bench: spec.Bench
    cell: Dict
    config: Dict
    reference: ModuleType
    traffic: Dict
    seed: int
    device: str
    spans: Spans
    tree: Tree
    trace: bool = False
    overrides: Dict = field(default_factory=dict)

    def port_config(self, mode: str) -> Dict:
        """The program's config dict for ``mode`` (``train``, ``infer``):
        the config file's mode section with its label tree,
        ``training.seed`` set to the run's seed."""
        d = merge(self.config["modes"][mode], {"classes": self.config["classes"]})
        d.setdefault("training", {})["seed"] = int(self.seed)
        return merge(d, self.overrides.get("modes", {}).get(mode, {}))


@dataclass
class Run:
    """What a per-layer metric's ``read(run)`` is given."""

    kind: str
    kernels: Dict
    e2e: Dict[str, float]
    spans: Dict[str, list]
    units: int
    window_peak_bytes: int
    trace: Optional[Dict]
    extras: Dict


def _finite(x: float) -> float:
    """A number for JSON: infinite or NaN (no answer, a crash) reads 1e300."""
    return float(x) if math.isfinite(x) else 1e300


def judge(numbers: Dict, limits: Dict):
    """(each number beside its limit, whether every one is within it); a
    number missing (a control that crashed) reads infinite."""
    checks = {k: {"value": _finite(numbers.get(k, math.inf)), "limit": v["limit"]}
              for k, v in limits.items()}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def _timeline(seconds) -> str:
    """A window's span times: count, median, 90th percentile, the three
    longest (ms) and where they fell."""
    if not seconds:
        return "none"
    ms = sorted(1e3 * x for x in seconds)
    top = sorted(range(len(seconds)), key=lambda i: -seconds[i])[:3]
    return (f"n {len(ms)} median {ms[len(ms) // 2]:.2f} p90 {ms[int(0.9 * (len(ms) - 1))]:.2f} "
            f"longest {[(i, round(1e3 * seconds[i], 2)) for i in top]}")


class GcClock:
    """The garbage collector's passes in a stretch of the run: count and
    seconds by generation."""

    def __init__(self):
        self.n, self.s, self._t = [0, 0, 0], [0.0, 0.0, 0.0], None

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            g = int(info.get("generation", 0))
            self.n[g] += 1
            self.s[g] += time.perf_counter() - self._t

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *a):
        gc.callbacks.remove(self._cb)
        return False

    def __str__(self):
        return " ".join(f"gen{g} {self.n[g]}x {1e3 * self.s[g]:.1f} ms" for g in range(3))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def context(bench: spec.Bench, name: str, seed: int, device: str, trace: bool = False,
            overrides: Optional[Dict] = None) -> Ctx:
    """The ``Ctx`` that cell ``name``'s traffic driver is given, the traffic
    patched by ``overrides``."""
    overrides = overrides or {}
    cell = bench.workload(name)
    config = bench.config(cell["config"])
    traffic = merge(bench.traffic(cell["traffic"]), overrides.get("traffic", {}))
    return Ctx(bench, cell, config, bench.reference(config), traffic, int(seed), device,
               Spans(), from_classes(config["classes"]), bool(trace), overrides)


def run_cell(bench: spec.Bench, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             control: Optional[str] = None, overrides: Optional[Dict] = None,
             say=print) -> Dict:
    """One run. With ``control`` (``fp8``, ``half_batch``, ``unchanged``:
    what the driver's check offers) that reading stands in the program's
    place and decides ``correct``, by the same limits; ``variants`` then
    gives every reading's verdict, the program's among them. ``overrides``
    (the CPU rehearsal's) patches the config's modes, the traffic and the
    limits."""
    t_start = time.perf_counter() if t_start is None else t_start
    overrides = overrides or {}
    ctx = context(bench, name, seed, device, trace, overrides)
    spans, traffic = ctx.spans, ctx.traffic
    cuda = torch.device(device).type == "cuda"
    drv = bench.driver(traffic["driver"]).Driver(ctx)
    kernels = bench.kernels()
    drv.setup()
    _sync(device)
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    spans.reset()
    setup_s = time.perf_counter() - t_start
    with GcClock() as gcs:
        res = drv.window(seconds)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    window_spans = {k: list(v) for k, v in spans.seconds.items()}
    seg, extras = None, {}
    if trace:
        before = kernelwork.read_counters(kernels)
        geos = []
        seg = profiling.segment(lambda: geos.extend(drv.segment(traffic["trace_units"])), spans)
        after = kernelwork.read_counters(kernels)
        seg["launches"] = {k: after[k] - before[k] for k in after}
        seg["geos"] = geos
        extras = drv.trace_extras()
    memory_peak = max(setup_peak, torch.cuda.max_memory_allocated()) if cuda else 0
    drv.release()
    checked = drv.check(bool(control))
    limits = merge(bench.limits(name), overrides.get("limits", {}))
    variants = {"program": checked["numbers"], **checked.get("control", {})}
    judged = {k: judge(v, limits) for k, v in variants.items()}
    shown = control or "program"
    numbers = variants[shown]
    checks, correct = judged[shown]

    metrics = {}
    if trace:
        run = Run(drv.kind, kernels, res["metrics"], window_spans, res["units"], window_peak, seg,
                  extras)
        for m in bench.per_layer(name):
            v = bench.metric_reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        for group, s in kernelwork.shares(seg, kernels).items():
            say(f"[kernel] {group}: {s['launches']} launches, least {s['least_s'] * 1e3:.4f} ms, "
                f"device {s['device_s'] * 1e3:.4f} ms, {s['share']:.2f} % of its roofline")
        say(f"[trace] busy {seg['busy_s']:.4f} s of {seg['window_s']:.4f} s, "
            f"{seg['device_events']} device events; extras {extras}")
    else:
        values = dict(res["metrics"], setup_s=setup_s)
        for m in bench.end_to_end(name):
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    if trace:
        device_info.update(busy_s=seg["busy_s"], window_s=seg["window_s"])
    say(f"[run] {name} seed {seed}: setup {setup_s:.3f} s, window {res['seconds']:.3f} s, "
        f"{res['units']} units, e2e {res['metrics']}, window peak {window_peak}, "
        f"detail {res.get('detail', {})}, numbers {numbers}, "
        f"check detail {checked.get('detail', {})}")
    for span, xs in window_spans.items():
        say(f"[window] {span}: {_timeline(xs)}")
    say(f"[window] gc: {gcs}")
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics, "device": device_info}
    if trace:
        out["breakdown"] = seg["breakdown"]
    if control:
        out["variants"] = {k: {"correct": c, "numbers": variants[k]}
                           for k, (_, c) in judged.items()}
    out["numbers"] = {k: _finite(v) for k, v in numbers.items()
                      if isinstance(v, (int, float))}
    out["checks"] = checks
    return out
