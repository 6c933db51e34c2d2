"""Each cell rehearsed end to end on the CPU at a tiny size through
``harness.run_cell`` (set-up, window, traced segment, the reference's
check), the control and the faults a cell can have coming out not
correct, the benchmark taking a made-up extra cell from files alone, and
``run.py`` refusing to run without a card.

    python -m pytest hbench/tests -q
"""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from hbench.core import harness, spec
from hbench.reference import lowp

TINY = {
    "r101-3level.train-769": {
        "modes": {"train": {"model": {"depth": 50}, "transform": {"resize": [64, 64]},
                            "training": {"batch_size": 4}}},
        "traffic": {"pool_batches": 4, "trace_units": 1}},
    "r50-2level.train-files": {
        "modes": {"train": {"transform": {"resize": [64, 64]},
                            "training": {"batch_size": 4, "num_workers": 2}}},
        "traffic": {"frames": 8, "frame_hw": [64, 128], "trace_units": 1}},
    "r101-3level.infer-1024": {
        "modes": {"infer": {"model": {"depth": 50}, "transform": {"resize": [64, 64]}}},
        "traffic": {"batch": 2, "pool": 4, "sample": 1, "trace_units": 1},
        # the widest gap grows with the pixels it is taken over: at 64^2 on
        # the CPU the program read 0.04-0.12 and the fp8 control 0.8-1.5
        # (seeds 11, 12, SEED), so the rehearsal's limit lies between
        "limits": {"mask_gap": {"limit": 0.4}}},
}
CELLS = list(TINY)
SEED = 3_000_000_019  # above 2**31, as the driver's are
BENCH = spec.Bench()


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rehearse(cell, trace=False, control=None, bench=None, overrides=None):
    return harness.run_cell(bench or BENCH, cell, SEED, 0.5, trace, device="cpu",
                            overrides=overrides or TINY[cell], control=control,
                            say=lambda _: None)


def test_every_cell_of_the_benchmark_is_rehearsed():
    assert sorted(CELLS) == sorted(w["name"] for w in BENCH.spec["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_end_to_end_on_the_cpu(cell):
    out = rehearse(cell, trace=True)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(BENCH.limits(cell))
    assert all(np.isfinite(c["value"]) for c in out["checks"].values())
    assert out["device"]["platform"] == "cpu" and "busy_s" in out["device"]
    want = {m["name"] for m in BENCH.per_layer(cell)}
    assert set(out["metrics"]) <= want  # a reader with nothing to read is left out
    json.dumps(out)


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_reports_the_end_to_end_metrics(cell):
    out = rehearse(cell)
    want = {m["name"] for m in BENCH.end_to_end(cell)}
    assert set(out["metrics"]) == want and "setup_s" in want
    assert all(v["value"] > 0 for v in out["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_fp8_control_in_the_programs_place_is_not_correct(cell):
    out = rehearse(cell, control="fp8")
    assert out["correct"] is False
    assert out["variants"]["fp8"]["correct"] is False and "program" in out["variants"]
    assert list(out)[-1] == "checks"


TRAIN = ["r101-3level.train-769", "r50-2level.train-files"]


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_its_state_unchanged_is_not_correct(cell, monkeypatch):
    from seghiero_torch.train import steps

    def still(model, composite, optimizer, cfg, batch, step, epoch=0, scheduler=None):
        model.train()
        loss, main, aux, _ = steps.forward_losses(model, composite, cfg, batch, step, step)
        return {"loss": loss.detach(), "main_loss": main.detach(), "aux_loss": aux.detach()}

    monkeypatch.setattr(steps, "train_step", still)
    assert rehearse(cell)["correct"] is False


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_left_out_is_not_correct(cell, monkeypatch):
    from seghiero_torch.train import steps

    real = steps.train_step

    def half(model, composite, optimizer, cfg, batch, step, epoch=0, scheduler=None):
        b = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return real(model, composite, optimizer, cfg, b, step, epoch, scheduler)

    monkeypatch.setattr(steps, "train_step", half)
    assert rehearse(cell)["correct"] is False


def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
    from seghiero_torch.infer import predictor

    real = predictor.decode_masks

    def altered(lo, out_hw, level_slices, backend="xla"):
        masks = real(lo, out_hw, level_slices, backend)
        fine = masks["fine"].clone()
        h, w = fine.shape[-2:]
        fine[..., : h // 4, : w // 4] = (fine[..., : h // 4, : w // 4] + 1) % (
            level_slices["fine"][1] - level_slices["fine"][0])
        return dict(masks, fine=fine)

    monkeypatch.setattr(predictor, "decode_masks", altered)
    assert rehearse("r101-3level.infer-1024")["correct"] is False


def test_the_control_precision_rounds_to_fp8():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = lowp.q8(x)
    assert 0 < (y - x).abs().max() < 3 * 2**-3
    y.sum().backward()
    assert torch.allclose(x.grad, torch.ones_like(x))


def test_a_made_up_extra_cell_needs_only_new_files(tmp_path):
    """A new traffic mix (the inference driver at another batch), a new
    per-layer metric, a new kernel count and the new cell's limits, as
    files beside copies of the harness's, plus entries in the spec."""
    home = tmp_path / "hbench"
    shutil.copytree(spec.HBENCH, home, ignore=shutil.ignore_patterns("tests", "__pycache__",
                                                                    ".cache"))
    (home / "traffic" / "infer-odd.json").write_text(json.dumps(
        {"driver": "infer_batch", "batch": 3, "pool": 6, "sample": 1, "trace_units": 1}))
    (home / "limits" / "r101-3level.infer-odd.json").write_text(
        (home / "limits" / "r101-3level.infer-1024.json").read_text())
    (home / "metrics" / "calls.infer.py").write_text(
        "def read(run):\n    return run.units if run.kind == 'infer' else None\n")
    (home / "kernels" / "made_up.py").write_text(
        'COUNTER = ("seghiero_torch.ops.upsample_argmax", "launches")\n'
        'NAMES = ("made_up_kernel",)\n\n\ndef launches(u):\n    return []\n')
    s = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    s["workloads"].append({"name": "r101-3level.infer-odd", "config": "r101-3level",
                           "traffic": "infer-odd", "chips": 1, "why": "a test"})
    next(m for m in s["end_to_end"] if m["name"] == "infer_images_per_s")["workloads"].append(
        "r101-3level.infer-odd")
    s["per_layer"].append({"name": "calls.infer", "unit": "count", "better": "higher",
                           "source": "host_clock", "layer": "predictor",
                           "moves": "infer_images_per_s",
                           "workloads": ["r101-3level.infer-odd"]})
    bench = spec.Bench(spec.ROOT / "BENCHMARK.json", spec=s, home=home)
    assert "made_up" in bench.kernels()
    ov = json.loads(json.dumps(TINY["r101-3level.infer-1024"]))
    ov["traffic"] = {}
    out = rehearse("r101-3level.infer-odd", trace=True, bench=bench, overrides=ov)
    assert out["metrics"]["calls.infer"]["value"] >= 1
    assert out["attempted"] % 3 == 0


def test_run_py_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible here")
    r = subprocess.run([sys.executable, str(spec.HBENCH / "run.py"), "--workload",
                        "r101-3level.infer-1024", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_the_harness_imports_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, '.');"
            "from hbench.core import harness, trainlib, predictlib; "
            "from hbench.core import spec; b = spec.Bench(); b.kernels(); "
            "[b.driver(t) for t in ('train_resident', 'train_files', 'infer_batch')]; "
            "[b.metric_reader(m['name']) for m in b.spec['per_layer']]; "
            "import hbench.calibrate; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('seghiero_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
