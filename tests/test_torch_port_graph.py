"""The train step's sync-free parts, on the CPU (``train/steps.py``): on the
card the step is captured as one CUDA graph, which needs every table on the
card before the capture, the step and the learning rate as device scalars,
and the zero gradients made once. Here:

* the composite losses with their tables made once (``device_table``) give
  the losses and gradients of tables built in every call, bit for bit, for
  the 2-level and 3-level composites and both triplet selections, and a
  second call makes no table;
* ``triplet_schedule_factor`` from a device step scalar equals it from a
  Python int, across the ramp's end;
* the learning-rate tensors that ``write_lrs`` fills from the schedule equal
  ``schedule_fn`` at every update count (poly, cosine and constant, with a
  warm-up, and ``backbone_lr_scale`` groups), and ``device_lrs`` swaps them
  in and back;
* on the CPU ``train_step`` is today's eager step: the same losses and
  parameters as that step written out, and no graph.

The card's side (replays against eager steps, launch counters, no sync,
another shape, a restore) is in ``tests/test_torch_port_cuda.py``.
"""

import copy

import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from seghiero_torch.config import SegHieroConfig
from seghiero_torch.losses import fast, hiera, tree_triplet
from seghiero_torch.losses.tree_triplet import triplet_schedule_factor
from seghiero_torch.models.segmenter import build_model
from seghiero_torch.train import steps
from seghiero_torch.train.optim import (
    clip_grad_global_norm_,
    device_lrs,
    make_optimizer,
    make_schedule,
    schedule_fn,
    write_lrs,
)

HW = 32
CLASSES_2L = {
    "coarse_to_fine_map": [[0, 3], [4, 6], [7], [8]],
    "coarse_names": {0: "a", 1: "b", 2: "c", 3: "d"},
    "fine_names": {i: f"f{i}" for i in range(9)},
}
CLASSES_3L = dict(CLASSES_2L, super_coarse_to_coarse_map=[[0, 2], [3]],
                  super_coarse_names={0: "x", 1: "y"})


def _cfg(classes=CLASSES_2L, **training):
    return SegHieroConfig.from_dict({
        "dataset": {"kind": "synthetic", "synthetic_size": 4},
        "classes": classes,
        "model": {"depth": 18, "dtype": "float32", "aspp_channels": 16, "c1_channels": 8,
                  "proj_dim": 8, "dilations": [1, 2, 3, 4]},
        "training": {"epochs": 1, "batch_size": 4, "lr": 0.01, "momentum": 0.9,
                     "weight_decay": 1e-4, "hiera_precision": "parity", "num_workers": 0,
                     **training},
        "transform": {"resize": [HW, HW], "hflip_prob": 0.5, "device_hflip": True},
    })


def _loss_inputs(cfg, seed=0):
    """Low-res logits, a normalized embedding and labels (with an ignored
    block) for ``cfg``'s hierarchy, the logits and embedding as leaves."""
    g = torch.Generator().manual_seed(seed)
    h = cfg.hierarchy
    logits = torch.randn((2, h.total_classes, HW // 4, HW // 4), generator=g)
    emb = torch.nn.functional.normalize(torch.randn((2, 8, 8, 8), generator=g), dim=1)
    labels = torch.randint(0, h.n_fine, (2, HW, HW), generator=g, dtype=torch.int32)
    labels[:, 4:9, 4:9] = 255
    return logits.requires_grad_(), emb.requires_grad_(), labels


def _loss_and_grads(composite, step, logits, emb, labels):
    for t in (logits, emb):
        t.grad = None
    loss = composite(step, emb, logits, logits, labels)
    loss.backward()
    return loss.detach(), logits.grad.clone(), emb.grad.clone()


@pytest.mark.parametrize("levels", ["2level", "3level"])
@pytest.mark.parametrize("selection", ["mask", "sorted"])
def test_tables_made_once_give_the_per_call_losses_bit_for_bit(levels, selection, monkeypatch):
    cfg = _cfg(CLASSES_2L if levels == "2level" else CLASSES_3L, triplet_selection=selection)
    composite = steps.make_composite_loss(cfg)
    inputs = _loss_inputs(cfg)
    hiera.device_table.cache_clear()
    cached = _loss_and_grads(composite, 7, *inputs)
    made = hiera.device_table.cache_info().misses
    assert made > 0
    again = _loss_and_grads(composite, 7, *inputs)
    assert hiera.device_table.cache_info().misses == made  # no table made twice
    per_call = hiera.device_table.__wrapped__  # a new tensor at every call
    for module in (hiera, fast, tree_triplet):
        monkeypatch.setattr(module, "device_table", per_call)
    fresh = _loss_and_grads(composite, 7, *inputs)
    for a, b, c in zip(cached, again, fresh):
        assert torch.equal(a, b) and torch.equal(a, c)
    # the step as a 0-dim tensor (the card's device scalar) gives the same bits
    as_tensor = _loss_and_grads(composite, torch.tensor(7), *inputs)
    for a, b in zip(cached, as_tensor):
        assert torch.equal(a, b)


@pytest.mark.parametrize("total", [5, 60_000])
def test_schedule_factor_from_a_device_step_equals_the_int_one(total):
    for step in (0, 1, total // 2, total - 2, total - 1, total, total + 1, total + 5, 3 * total):
        want = triplet_schedule_factor(step, total)
        got = triplet_schedule_factor(torch.tensor(step), total)
        assert got.dtype == torch.float32 and torch.equal(got, want), step
    assert float(triplet_schedule_factor(torch.tensor(total + 1), total)) == 0.5


@pytest.mark.filterwarnings("ignore:Detected call of")
@pytest.mark.parametrize("kind", ["poly", "cosine", "constant"])
def test_the_lr_tensors_follow_the_schedule_at_every_update_count(kind):
    cfg = _cfg(lr_schedule={"type": kind, "warmup_steps": 3, "end_lr": 1e-4},
               backbone_lr_scale=0.1, wd_skip_norm_bias=True)
    t = cfg.training
    model = build_model(cfg)
    optimizer = make_optimizer(t, model)
    assert len(optimizer.param_groups) == 4  # backbone / rest × decay / none
    scheduler = make_schedule(t, 12, optimizer)
    fn = schedule_fn(t, 12)
    lrs = [torch.zeros((), dtype=torch.float32) for _ in optimizer.param_groups]
    scales = [g["initial_lr"] / t.lr for g in optimizer.param_groups]
    assert sorted(set(scales)) == pytest.approx([0.1, 1.0])
    for count in range(16):
        write_lrs(optimizer, lrs)
        for lr, g, scale in zip(lrs, optimizer.param_groups, scales):
            assert lr.item() == np.float32(g["lr"])
            assert lr.item() == pytest.approx(fn(count) * scale, rel=1e-6, abs=1e-12)
        with device_lrs(optimizer, lrs):
            assert all(g["lr"] is lr for g, lr in zip(optimizer.param_groups, lrs))
        assert all(isinstance(g["lr"], float) for g in optimizer.param_groups)
        scheduler.step()


def _todays_step(model, composite, optimizer, cfg, batch, step, scheduler):
    """The eager step as ``train_step`` ran it before the CUDA graph."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss, main, aux, _ = steps.forward_losses(model, composite, cfg, batch, step,
                                              flip_step=step)
    loss.backward()
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    clip_grad_global_norm_(model.parameters(), cfg.training.grad_clip_norm)
    optimizer.step()
    scheduler.step()
    return {"loss": loss.detach(), "main_loss": main.detach(), "aux_loss": aux.detach()}


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_on_the_cpu_train_step_is_todays_eager_step(optimizer):
    cfg = _cfg(grad_clip_norm=1.0, backbone_lr_scale=0.5, optimizer=optimizer,
               lr_schedule={"type": "poly", "warmup_steps": 2})
    torch.manual_seed(0)
    model = build_model(cfg)
    twin = copy.deepcopy(model)
    composite = steps.make_composite_loss(cfg)
    runs = []
    for m in (model, twin):
        opt = make_optimizer(cfg.training, m)
        runs.append((m, opt, make_schedule(cfg.training, 20, opt)))
    g = np.random.default_rng(3)
    for step in range(5):  # past the card's warm-up and capture
        batch = {"image": torch.from_numpy(g.integers(0, 256, (4, HW, HW, 3), dtype=np.uint8)),
                 "fine": torch.from_numpy(g.integers(0, 9, (4, HW, HW)).astype(np.int32))}
        (m, opt, sch), (m2, opt2, sch2) = runs
        got = steps.train_step(m, composite, opt, cfg, batch, step, 0, sch)
        want = _todays_step(m2, composite, opt2, cfg, batch, step, sch2)
        for k in want:
            assert torch.equal(got[k], want[k]), (step, k)
    for (n, p), p2 in zip(model.named_parameters(), twin.parameters()):
        assert torch.equal(p, p2), n
    runner = steps._steps[runs[0][1]]
    assert not runner.cuda and runner.graph is None
