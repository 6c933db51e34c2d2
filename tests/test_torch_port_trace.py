"""The port's spans (``seghiero_torch/trace.py``) on the CPU, at a tiny size.

* off (no profiler): ``train_step``, a ``BatchLoader`` epoch and
  ``predict_array`` record nothing and never reach ``record_function``,
  the clock or the lock; the evaluation records no span but the model's own;
* under ``torch.profiler``: the train step's four phase spans under
  ``train.step``, in the profiler's events too and covering 90 % of the
  step; the model's ``model.backbone`` and ``model.head`` once a forward,
  under ``train.forward`` and ``predict.forward``; the loader's ``loader.batch`` (worker thread) and ``loader.wait``
  once a batch; ``predict`` and its four children once a call; a new
  stretch of recording resets the totals, and a span that outlives its
  stretch is left out;
* the benchmark's eight span metrics (``hbench/metrics/``) read them;
* ``output.profile_dir``: ``fit`` and the infer CLI write ``trace.json``
  and ``spans.json``;
* the PyTorch flag the module reads exists, and totals survive threads.
"""

import json
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from torch.profiler import ProfilerActivity, profile

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from hbench.core.spec import load_module
from seghiero_torch import trace
from seghiero_torch.config import SegHieroConfig
from seghiero_torch.data.pipeline import BatchLoader
from seghiero_torch.infer.__main__ import main as infer_main
from seghiero_torch.infer.predictor import Predictor
from seghiero_torch.models.convert import reference_checkpoint
from seghiero_torch.models.segmenter import build_model
from seghiero_torch.train.optim import make_optimizer, make_schedule
from seghiero_torch.train.steps import eval_step, make_composite_loss, train_step
from seghiero_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]
HW = 64
CLASSES = {
    "coarse_to_fine_map": [[0, 3], [4, 6], [7], [8]],
    "coarse_names": {0: "a", 1: "b", 2: "c", 3: "d"},
    "fine_names": {i: f"f{i}" for i in range(9)},
}
PHASES = ("train.forward", "train.loss", "train.backward", "train.optimizer")
PREDICT = ("predict.upload", "predict.forward", "predict.decode", "predict.download")
MODEL = ("model.backbone", "model.head")


def _cfg_dict(tmp=None):
    d = {
        "dataset": {"kind": "synthetic", "synthetic_size": 8},
        "classes": CLASSES,
        "model": {"depth": 18, "dtype": "float32", "aspp_channels": 16, "c1_channels": 8,
                  "proj_dim": 8, "dilations": [1, 2, 3, 4]},
        "training": {"epochs": 1, "batch_size": 2, "lr": 0.01, "momentum": 0.9,
                     "weight_decay": 1e-4, "hiera_precision": "parity", "num_workers": 0,
                     "grad_clip_norm": 1.0, "log_every": 100},
        "transform": {"resize": [HW, HW], "hflip_prob": 0.0},
    }
    if tmp is not None:
        d["output"] = {"checkpoint_dir": str(tmp / "ckpt"), "project_name": "trace"}
    return d


def _batch(seed, n=2):
    g = np.random.default_rng(seed)
    return {"image": torch.from_numpy(g.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8)),
            "fine": torch.from_numpy(g.integers(0, 9, (n, HW, HW)).astype(np.int32))}


@pytest.fixture(scope="module")
def training():
    cfg = SegHieroConfig.from_dict(_cfg_dict())
    torch.manual_seed(0)
    model = build_model(cfg)
    optimizer = make_optimizer(cfg.training, model)
    scheduler = make_schedule(cfg.training, 100, optimizer)
    composite = make_composite_loss(cfg)
    state = {"step": 0}

    def step():
        train_step(model, composite, optimizer, cfg, _batch(state["step"]), state["step"], 0,
                   scheduler)
        state["step"] += 1

    step()  # warm
    step.parts = (model, composite, cfg)
    return step


@pytest.fixture(scope="module")
def predictor():
    return Predictor(SegHieroConfig.from_dict(_cfg_dict()), None, device="cpu")


def _images():
    return np.random.default_rng(5).integers(0, 256, (2, HW, HW, 3), dtype=np.uint8)


def _epoch(n_batches=3):
    data = [{k: v[0].numpy() for k, v in _batch(100 + i, 1).items()}
            for i in range(2 * n_batches)]
    loader = BatchLoader(data, 2, shuffle=True, drop_last=True, seed=1, prefetch=2)
    return sum(1 for _ in loader)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof, trace.totals()


class _Refuse:
    def __getattr__(self, name):
        raise AssertionError(f"the off path reached {name}")

    def __enter__(self):
        raise AssertionError("the off path took the lock")


def test_off_records_nothing_and_reaches_no_profiler_clock_or_lock(
        training, predictor, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function with no profiler running")

    before = trace.totals()
    # the module's view of PyTorch's profiler: the flag off, record_function
    # refused (the optimizer's own record_function calls stay PyTorch's)
    monkeypatch.setattr(trace, "_profiler", types.SimpleNamespace(
        _is_profiler_enabled=False, record_function=refuse))
    monkeypatch.setattr(trace, "time", _Refuse())
    monkeypatch.setattr(trace, "_lock", _Refuse())
    training()
    assert _epoch() == 3
    predictor.predict_array(_images())
    monkeypatch.undo()
    assert trace.totals() == before
    assert trace.span("x") is trace.OFF  # one shared no-op object


def test_train_step_records_its_four_phases_under_the_step(training):
    training()  # recording off before the profiler: the totals start fresh
    prof, t = _profiled(training)
    assert t["train.step"]["count"] == 1 and t["train.step"]["parent"] is None
    for name in PHASES:
        assert t[name]["parent"] == "train.step", name
        assert t[name]["count"] == (2 if name == "train.optimizer" else 1), name
    covered = sum(t[name]["seconds"] for name in PHASES)
    assert covered >= 0.9 * t["train.step"]["seconds"]
    ranges = {}
    for e in prof.events():
        if e.name.startswith(trace.PREFIX):
            ranges.setdefault(e.name[len(trace.PREFIX):], []).append(
                (e.time_range.start, e.time_range.end))
    (s0, s1), = ranges["train.step"]
    for name in PHASES:
        assert ranges[name] and all(s0 <= a <= b <= s1 for a, b in ranges[name]), name
    assert not any(k.startswith("eval.") for k in t)


def test_the_model_records_its_backbone_and_head_under_each_forward(training, predictor):
    training()
    prof, t = _profiled(training)
    for name in MODEL:
        assert t[name]["count"] == 1 and t[name]["parent"] == "train.forward", name
    assert t["model.backbone"]["seconds"] + t["model.head"]["seconds"] <= \
        t["train.forward"]["seconds"]
    assert {trace.PREFIX + n for n in MODEL} <= {e.name for e in prof.events()}
    predictor.predict_array(_images())
    _, t = _profiled(lambda: predictor.predict_array(_images()))
    for name in MODEL:
        assert t[name]["count"] == 1 and t[name]["parent"] == "predict.forward", name


def test_a_loader_epoch_counts_one_batch_and_one_wait_a_batch():
    _epoch(1)
    _, t = _profiled(lambda: _epoch(3))
    assert t["loader.batch"]["count"] == 3 and t["loader.wait"]["count"] == 3
    assert t["loader.batch"]["parent"] is None  # the worker thread's own stack
    assert t["loader.batch"]["seconds"] > 0


def test_predict_array_records_predict_and_its_four_children(predictor):
    predictor.predict_array(_images())
    _, t = _profiled(lambda: [predictor.predict_array(_images()) for _ in range(2)])
    assert t["predict"]["count"] == 2 and t["predict"]["parent"] is None
    for name in PREDICT:
        assert t[name]["count"] == 2 and t[name]["parent"] == "predict", name


def test_a_new_stretch_of_recording_resets_the_totals(training, predictor):
    training()
    _, first = _profiled(lambda: (training(), training()))
    assert first["train.step"]["count"] == 2
    predictor.predict_array(_images())  # recording off between the sessions
    _, second = _profiled(training)
    assert second["train.step"]["count"] == 1 and "predict" not in second
    training()  # recording off again
    _, third = _profiled(lambda: predictor.predict_array(_images()))
    assert third["predict"]["count"] == 1 and "train.step" not in third


def test_a_span_that_outlives_its_stretch_is_left_out():
    with trace.span("before"):  # recording off: the next stretch starts fresh
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("kept"):
            pass
        late = trace.span("late")
        late.__enter__()
    late.__exit__(None, None, None)  # a worker's batch across the segment's end
    assert set(trace.totals()) == {"kept"}


def test_eval_step_records_no_span(training, monkeypatch):
    model, composite, cfg = training.parts
    batch = _batch(7)
    coarse = np.repeat(np.arange(4), [4, 3, 1, 1])  # CLASSES' coarse_to_fine_map
    batch["coarse"] = torch.from_numpy(coarse[batch["fine"].numpy()].astype(np.int32))

    real = trace.span

    def refuse(name):  # the model's own spans time any forward
        if name in MODEL:
            return real(name)
        raise AssertionError(f"the evaluation opened the span {name}")

    monkeypatch.setattr(trace, "span", refuse)
    with profile(activities=[ProfilerActivity.CPU]):
        out = eval_step(model, composite, cfg, batch, 0)
    assert torch.isfinite(out["loss"])


METRICS = {
    "forward_host_ms.train": "train", "loss_host_ms.train": "train",
    "backward_host_ms.train": "train", "optimizer_host_ms.train": "train",
    "loader_busy_ms.train": "loader", "loader_queue_wait_ms.train": "loader",
    "issue_host_ms.infer": "infer", "result_wait_ms.infer": "infer",
    "backbone_host_ms.train": "train",
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_the_span_metrics_read_the_totals(name, training, predictor):
    what = METRICS[name]
    run = {"train": training, "loader": lambda: _epoch(3),
           "infer": lambda: predictor.predict_array(_images())}[what]
    run()
    _profiled(run)
    reader = load_module(ROOT / "hbench" / "metrics" / f"{name}.py")
    kind = "infer" if what == "infer" else "train"
    other = "train" if kind == "infer" else "infer"
    seg = {"busy_s": 0.5, "window_s": 1.0}
    value = reader.read(types.SimpleNamespace(kind=kind, trace=seg))
    assert value is not None and value > 0
    assert reader.read(types.SimpleNamespace(kind=other, trace=seg)) is None
    assert reader.read(types.SimpleNamespace(kind=kind, trace=None)) is None
    entry = next(m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
                 if m["name"] == name)
    assert entry["source"] == "program_span" and entry["unit"] == "ms"


def test_the_profiler_flag_the_module_reads_exists():
    assert torch.autograd.profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True
        assert trace._profiling()
    assert not trace._profiling()


def test_totals_lose_no_span_across_threads():
    n_threads, n_spans = 16, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with trace.span("stress"):
                    pass

        with trace.span("before"):  # recording off: the stretch starts fresh
            pass
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        with profile(activities=[ProfilerActivity.CPU]):
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert trace.totals()["stress"]["count"] == n_threads * n_spans


def _trace_names(path):
    return {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}


def test_fit_with_profile_dir_writes_the_trace_and_the_spans(tmp_path):
    d = _cfg_dict(tmp_path)
    d["output"]["profile_dir"] = str(tmp_path / "prof")
    Trainer(SegHieroConfig.from_dict(d), device="cpu", verbose=False).fit()
    assert "seghiero::train.step" in _trace_names(tmp_path / "prof" / "trace.json")
    spans = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert spans["train.step"]["count"] == 2  # steps 3 and 4 of the epoch's 4
    assert set(spans) <= {"train.step", *PHASES, *MODEL, "loader.batch", "loader.wait"}


def test_infer_cli_with_profile_dir_writes_the_trace_and_the_spans(tmp_path, predictor):
    from PIL import Image

    pth = tmp_path / "model.pth"
    torch.save(reference_checkpoint(predictor.model), pth)
    images = tmp_path / "images"
    images.mkdir()
    for i, img in enumerate(np.concatenate([_images(), _images()])):
        Image.fromarray(img).save(images / f"{i}.png")
    d = _cfg_dict()
    d["output"] = {"profile_dir": str(tmp_path / "prof")}
    cfg = tmp_path / "infer.yaml"
    cfg.write_text(yaml.safe_dump(d))
    assert infer_main(["--config", str(cfg), "--image-dir", str(images), "--batch-size", "1",
                       "--checkpoint", str(pth), "--device", "cpu",
                       "--output-dir", str(tmp_path / "out")]) == 0
    assert "seghiero::predict" in _trace_names(tmp_path / "prof" / "trace.json")
    spans = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert spans["predict"]["count"] == 3  # batches 2-4 of 4
