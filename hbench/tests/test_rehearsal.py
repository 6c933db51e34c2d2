"""Each cell of ``BENCHMARK.json`` rehearsed end to end on the CPU at the
tiny size of its ``rehearsal/<cell>.json`` through ``harness.run_cell``
(set-up, window, traced segment, the reference's check), the control and
the faults a cell can have coming out not correct, the benchmark taking a
made-up configuration and cell from files alone, the reference's
optimizer found by name, and ``run.py`` refusing to run without a card.

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

SEED = 3_000_000_019  # above 2**31, as the driver's are
BENCH = spec.Bench()
CELLS = [w["name"] for w in BENCH.spec["workloads"]]


def _kind(bench, cell):
    return bench.driver(bench.traffic(bench.workload(cell)["traffic"])["driver"]).Driver.kind


TRAIN = [c for c in CELLS if _kind(BENCH, c) == "train"]
INFER = [c for c in CELLS if _kind(BENCH, c) == "infer"]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rehearse(cell, trace=False, control=None, bench=None, overrides=None):
    bench = bench or BENCH
    return harness.run_cell(bench, cell, SEED, 0.5, trace, device="cpu",
                            overrides=overrides or bench.rehearsal(cell), control=control,
                            say=lambda _: None)


def test_every_cell_of_the_benchmark_is_rehearsed():
    """Every cell has its rehearsal file, whose overrides patch only what a
    run reads."""
    for cell in CELLS:
        ov = BENCH.rehearsal(cell)
        assert set(ov) <= {"modes", "traffic", "limits", "note"}, cell


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


@pytest.mark.parametrize("cell", INFER)
def test_an_answer_altered_where_it_is_produced_is_not_correct(cell, monkeypatch):
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
    assert rehearse(cell)["correct"] is False


def test_the_control_precision_rounds_to_fp8():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = lowp.q8(x)
    assert 0 < (y - x).abs().max() < 3 * 2**-3
    y.sum().backward()
    assert torch.allclose(x.grad, torch.ones_like(x))


# a made-up configuration's reference module: reference/model.py's model,
# with residual-last names of its own, leaving a mark where it is built
MADE_UP_REFERENCE = '''from pathlib import Path

from hbench.reference import model as _model
from hbench.reference.model import *  # noqa: F401,F403

RESIDUAL_LAST = (".bn3.", "aux_head.1.")


def build(model_cfg, tree):
    Path(__file__).with_suffix(".built").write_text(repr(RESIDUAL_LAST))
    return _model.build(model_cfg, tree)
'''

# a made-up optimizer's update: plain SGD, leaving a mark at each step
PLAIN_SGD = '''from pathlib import Path


def update(params, grads, state, training, step):
    state.setdefault("steps", []).append(step)
    Path(__file__).with_suffix(".steps").write_text(repr(state["steps"]))
    for k, p in params.items():
        p -= float(training["lr"]) * grads[k]
'''


def _harness_copy(tmp_path):
    """A copy of the harness under ``tmp_path/hbench`` and the spec."""
    home = tmp_path / "hbench"
    shutil.copytree(spec.HBENCH, home, ignore=shutil.ignore_patterns("tests", "__pycache__",
                                                                    ".cache"))
    return home, json.loads((spec.ROOT / "BENCHMARK.json").read_text())


def test_a_made_up_extra_cell_needs_only_new_files(tmp_path):
    """A made-up configuration (its own reference module, which re-exports
    ``reference/model.py`` with its own ``RESIDUAL_LAST``), a new traffic
    mix (the inference driver at another batch), a new per-layer metric, a
    new kernel count, and the new cell's rehearsal and limits, as files
    beside copies of the harness's, plus entries in the spec."""
    home, s = _harness_copy(tmp_path)
    config = json.loads((home / "configs" / "r101-3level.json").read_text())
    config["reference"] = "hbench/reference/made_up.py"
    (home / "configs" / "made-up.json").write_text(json.dumps(config))
    (home / "reference" / "made_up.py").write_text(MADE_UP_REFERENCE)
    (home / "traffic" / "infer-odd.json").write_text(json.dumps(
        {"driver": "infer_batch", "batch": 3, "pool": 6, "sample": 1, "trace_units": 1}))
    rehearsal = BENCH.rehearsal("r101-3level.infer-1024")
    rehearsal["traffic"] = {}
    (home / "rehearsal" / "made-up.infer-odd.json").write_text(json.dumps(rehearsal))
    (home / "limits" / "made-up.infer-odd.json").write_text(
        (home / "limits" / "r101-3level.infer-1024.json").read_text())
    (home / "metrics" / "calls.infer.py").write_text(
        "def read(run):\n    return run.units if run.kind == 'infer' else None\n")
    (home / "kernels" / "made_up.py").write_text(
        'COUNTER = ("seghiero_torch.ops.upsample_argmax", "launches")\n'
        'NAMES = ("made_up_kernel",)\n\n\ndef launches(u):\n    return []\n')
    s["configs"].append({"name": "made-up", "source": "https://example.org/made-up",
                         "file": "hbench/configs/made-up.json", "reduced": [], "why": "a test"})
    s["workloads"].append({"name": "made-up.infer-odd", "config": "made-up",
                           "traffic": "infer-odd", "chips": 1, "why": "a test"})
    next(m for m in s["end_to_end"] if m["name"] == "infer_images_per_s")["workloads"].append(
        "made-up.infer-odd")
    s["per_layer"].append({"name": "calls.infer", "unit": "count", "better": "higher",
                           "source": "host_clock", "layer": "predictor",
                           "moves": "infer_images_per_s", "workloads": ["made-up.infer-odd"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    bench = spec.Bench(tmp_path / "BENCHMARK.json", home=home)
    assert "made_up" in bench.kernels()
    out = rehearse("made-up.infer-odd", trace=True, bench=bench)
    # the made-up reference module was the one built, for the program's
    # weights and for the reference's check
    assert (home / "reference" / "made_up.built").read_text() == repr((".bn3.", "aux_head.1."))
    assert out["metrics"]["calls.infer"]["value"] >= 1
    assert out["attempted"] % 3 == 0


@pytest.mark.parametrize("cell", TRAIN)
def test_the_reference_optimizer_is_found_by_name(cell, tmp_path):
    """``training.optimizer`` names ``reference/optim/<name>.py``: a made-up
    plain SGD in a copy of the harness is the update the reference's steps
    take, each parameter moving by the learning rate times its first
    gradient. The reference runs alone: the program has SGD only."""
    from hbench.core import scene

    home, s = _harness_copy(tmp_path)
    (home / "reference" / "optim" / "made_up.py").write_text(PLAIN_SGD)
    bench = spec.Bench(spec.ROOT / "BENCHMARK.json", spec=s, home=home)
    ov = harness.merge(bench.rehearsal(cell), {"modes": {"train": {"training": {
        "optimizer": "made_up", "lr": 0.01}}}})
    drv = bench.driver(bench.traffic(bench.workload(cell)["traffic"])["driver"]).Driver(
        harness.context(bench, cell, SEED, "cpu", overrides=ov))
    images, fine = scene.scenes(scene.generator(SEED, "cpu", stream=1), drv.batch_size,
                                drv.hw, drv.ctx.tree.n_fine)
    out = drv._reference(drv._weights(), [{"image": images, "fine": fine.to(torch.int32)}])
    assert (home / "reference" / "optim" / "made_up.steps").read_text() == "[0]"
    grads, changes = out["grad_norms"], out["change_norms"]
    median = sorted(grads.values())[len(grads) // 2]
    moved = [k for k, g in grads.items() if g >= median]
    assert moved and all(changes[k] == pytest.approx(0.01 * grads[k], rel=1e-3) for k in moved)


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
            "[b.reference(b.config(c['name'])) for c in b.spec['configs']]; b.optimizer('sgd'); "
            "[b.metric_reader(m['name']) for m in b.spec['per_layer']]; "
            "import hbench.calibrate; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('seghiero_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
