"""Swin + UperNet on the port (``backbone: swin``, ``head: upernet``,
``optimizer: adamw``) on the CPU, at a tiny size: Swin-T with window 3 at
64², batch 2, where every stage pads (16, 8, 4, 2 to 18, 9, 6, 3) and
every odd block shifts.

* against the JAX package: a JAX ``SwinBackbone`` + ``UPerNetHead`` with
  random weights, norms and BatchNorm statistics, carried into the port by
  ``models/convert.py``: logits, embedding and aux logits in f32;
* against the benchmark's plain reference (``hbench/reference/swin.py``,
  its AdamW ``hbench/reference/optim/adamw.py`` and its losses), one
  seeded state dict loaded into both: the forward's three outputs, the
  2-level loss and every parameter's gradient (the relative-position
  tables' included), three AdamW steps;
* ``window_attention`` against ``softmax(QKᵀ/√d + bias)·V`` in f64, with
  a shift mask over a padded map, forward and backward (the bias's
  gradient included);
* the tables in AdamW's group without decay;
* the shipped ``configs/example-swin-upernet.yaml`` through the train
  entry point for one tiny epoch and through ``Predictor``.

Every comparison is in f32 unless it says otherwise; each tolerance is
written beside its reason.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from hbench.core import scene, weights
from hbench.reference import swin as ref_swin
from hbench.reference.losses import total_loss
from hbench.reference.optim import adamw as ref_adamw
from hbench.reference.train import normalize
from hbench.reference.tree import from_classes
from seghiero_torch.config import SegHieroConfig as PortConfig
from seghiero_torch.infer.predictor import Predictor
from seghiero_torch.models import swin
from seghiero_torch.models.convert import export_reference_checkpoint, load_reference_checkpoint
from seghiero_torch.models.segmenter import build_model as port_build_model
from seghiero_torch.ops import attention
from seghiero_torch.train.__main__ import main as port_train_main
from seghiero_torch.train.optim import make_optimizer, make_schedule
from seghiero_torch.train.steps import forward_losses, make_composite_loss
from seghiero_tpu.config import SegHieroConfig as JaxConfig
from seghiero_tpu.models.segmenter import build_model as jax_build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, BATCH, WINDOW, SEED = 64, 2, 3, 3_000_000_019
CLASSES_2L = {
    "coarse_to_fine_map": [[0, 3], [4, 6], [7]],
    "coarse_names": {0: "a", 1: "b", 2: "c"},
    "fine_names": {i: f"f{i}" for i in range(8)},
}
TRAINING = {"batch_size": BATCH, "optimizer": "adamw", "lr": 1e-3, "weight_decay": 0.01,
            "wd_skip_norm_bias": True, "hiera_precision": "parity"}


def _cfg_dict(**training):
    return {
        "classes": CLASSES_2L,
        "model": {"backbone": "swin", "backbone_options": {"variant": "tiny", "window": WINDOW},
                  "head": "upernet", "head_options": {"channels": 32, "dropout_rate": 0.0},
                  "proj_dim": 16, "dtype": "float32"},
        "training": dict(TRAINING, **training),
        "transform": {"resize": [HW, HW]},
    }


def _pair(d):
    """(port model, reference model, tree), both holding one seeded state dict."""
    tree = from_classes(d["classes"])
    sd = weights.make(ref_swin.build(d["model"], tree), SEED, "cpu", ref_swin.RESIDUAL_LAST)
    port = port_build_model(PortConfig.from_dict(d))
    port.load_state_dict(sd, strict=True)
    return port, weights.materialize(ref_swin.build(d["model"], tree), sd, "cpu"), tree


def _batch(tree):
    images, fine = scene.scenes(scene.generator(SEED, "cpu", stream=1), BATCH, (HW, HW),
                                tree.n_fine)
    return {"image": images, "fine": fine.to(torch.int32)}


def _rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def test_outputs_match_the_jax_package():
    """A JAX Swin-T (window 3) + UPerNet with random weights (normal kernels
    at 1/√fan_in, relative-position tables at 1, LayerNorm and BatchNorm
    scales in 0.5–1.5, shifts, biases and means at 0.1, variances in
    0.5–1.5), carried into the port, eval mode, the same f32 images: the
    logits, embedding and aux logits each within 1e-5 relative (1.4e-6
    measured: XLA:CPU and oneDNN sum the matmuls, convolutions and
    LayerNorms in other orders). The variables' shapes come from
    ``jax.eval_shape``, so the JAX side compiles once, its ``apply``."""
    d = _cfg_dict()
    jmodel = jax_build_model(JaxConfig.from_dict(d))
    shapes = jax.eval_shape(lambda x: jmodel.init(jax.random.key(0), x, train=False),
                            jax.ShapeDtypeStruct((1, HW, HW, 3), jnp.float32))
    rng = np.random.default_rng(7)

    def draw(path, leaf):
        name, shape = str(path[-1].key), leaf.shape
        if name == "kernel":
            return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.standard_normal(shape).astype(np.float32) * (
            1.0 if name == "rel_bias_table" else 0.1)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    port = port_build_model(PortConfig.from_dict(d))
    load_reference_checkpoint(port, export_reference_checkpoint(variables, 0,
                                                                swin_variant="tiny"))
    port.eval()
    x = np.random.default_rng(8).standard_normal((BATCH, HW, HW, 3)).astype(np.float32)
    want = jax.device_get(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, x))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k in ("logits", "embedding", "aux_logits"):
        w = np.asarray(want[k]).transpose(0, 3, 1, 2)
        assert got[k].shape == w.shape, k
        assert np.linalg.norm(got[k].numpy() - w) <= 1e-5 * np.linalg.norm(w), k


def test_forward_matches_the_plain_reference():
    """Train mode (batch statistics), the seeded state dict in both: each
    output within 1e-5 relative (7e-7 measured: f32 sums in other orders
    through 12 blocks and UperNet)."""
    port, ref, tree = _pair(_cfg_dict())
    port.train(), ref.train()
    x = normalize(_batch(tree)["image"], {})
    with torch.no_grad():
        got, want = port(x), ref(x)
    assert set(got) == set(want) == {"logits", "embedding", "aux_logits"}
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert _rel(got[k], want[k]) < 1e-5, (k, _rel(got[k], want[k]))


def test_loss_and_every_gradient_match_the_plain_reference():
    """The port's 2-level composite (BCE, CE per level, tree triplet, aux
    CE) against the reference's ``total_loss``: the loss of each model
    within 1e-5 relative; the loss's gradient by each output, on the same
    outputs, within 1e-4 relative. Then that gradient carried back
    through both models: every parameter's gradient, each
    relative-position table's among them, within 2e-4 of ``max(‖leaf‖,
    median leaf)`` (the median guards leaves whose gradient is round-off
    alone, such as a bias that a train-mode BatchNorm cancels; 6.9e-5
    measured at the 1×1 pool's convolution, whose train-mode BatchNorm
    normalizes two values a channel, every other leaf under 2e-5)."""
    from seghiero_torch.losses.fast import aux_ce_fast

    d = _cfg_dict()
    port, ref, tree = _pair(d)
    port.train(), ref.train()
    composite = make_composite_loss(PortConfig.from_dict(d))
    batch = _batch(tree)
    fine, x = batch["fine"], normalize(batch["image"], {})

    def port_loss(out):
        main = composite(0, out["embedding"], out["logits"], out["logits"], fine)
        return main + 0.4 * aux_ce_fast(out["aux_logits"], fine, 255, hiera_precision="parity")

    got, want = port(x), ref(x)
    with torch.no_grad():
        lp, lr_ = float(port_loss(got)), float(total_loss(want, fine, tree, 0, 1.0))
    assert abs(lp - lr_) <= 1e-5 * abs(lr_)
    leaves = {k: v.detach().clone().requires_grad_() for k, v in want.items()}
    twins = {k: v.detach().clone().requires_grad_() for k, v in want.items()}
    port_loss(leaves).backward()
    total_loss(twins, fine, tree, 0, 1.0).backward()
    for k in ("logits", "aux_logits"):
        assert _rel(leaves[k].grad, twins[k].grad) < 1e-4, k
    cot = {k: v.grad if v.grad is not None else torch.zeros_like(v) for k, v in twins.items()}
    sum((got[k] * cot[k]).sum() for k in cot).backward()
    sum((want[k] * cot[k]).sum() for k in cot).backward()
    pg = dict(port.named_parameters())
    norms = {k: float(p.grad.norm()) for k, p in ref.named_parameters() if p.grad is not None}
    med = sorted(norms.values())[len(norms) // 2]
    assert set(norms) == set(pg)
    tables = [k for k in norms if k.endswith("relative_position_bias_table")]
    assert len(tables) == 12 and all(norms[k] > 0 for k in tables)
    for k, p in ref.named_parameters():
        want_g = p.grad.reshape(pg[k].shape)
        assert float((pg[k].grad - want_g).norm()) <= 2e-4 * max(norms[k], med), k


def test_three_adamw_steps_match_the_reference_update():
    """Three updates of the port's optimizer (AdamW over the parameter
    groups, decay on conv and linear weights only, the warm-up schedule)
    against three of ``reference/optim/adamw.py`` from the same seeded
    parameters and the same gradients a step (the model's own first,
    seeded ones after): every entry within 1e-5 of its change plus 16 f32
    ulps of the largest value it can have passed, as in the SegFormer
    test; the tables, held flat in the reference so that it decays them
    no more than the program does, move alike."""
    d = _cfg_dict(lr_schedule={"type": "poly", "power": 1.0, "warmup_steps": 2})
    port, ref, tree = _pair(d)
    cfg = PortConfig.from_dict(d)
    p0 = {k: v.detach().clone() for k, v in port.named_parameters()}
    optimizer = make_optimizer(cfg.training, port)
    scheduler = make_schedule(cfg.training, 10**9, optimizer)
    loss, *_ = forward_losses(port, make_composite_loss(cfg), cfg, _batch(tree), 0)
    loss.backward()
    gen = torch.Generator().manual_seed(11)
    grads = [{k: p.grad.detach().clone() for k, p in port.named_parameters()}]
    for _ in range(2):
        grads.append({k: torch.randn(v.shape, generator=gen) * 1e-2 for k, v in p0.items()})
    params = dict(ref.named_parameters())
    state = {}
    for step, g in enumerate(grads):
        for k, p in port.named_parameters():
            p.grad = g[k].clone()
        optimizer.step()
        scheduler.step()
        with torch.no_grad():
            ref_adamw.update(params, {k: g[k].reshape(params[k].shape) for k in g}, state,
                             d["training"], step)
    for k, p in port.named_parameters():
        mine = params[k].detach().reshape(p.shape)
        change = mine - p0[k]
        assert change.norm() > 0, k
        reach = p0[k].abs() + len(grads) * 1e-3
        tol = 1e-5 * change.abs() + 16 * torch.finfo(torch.float32).eps * reach
        assert ((p.detach() - mine).abs() <= tol).all(), k


def test_relative_position_tables_are_not_decayed():
    """Under ``wd_skip_norm_bias`` the tables sit in AdamW's group without
    decay (they are not conv or linear weights), as mmseg's
    ``decay_mult=0``; ``qkv`` weights are decayed."""
    cfg = PortConfig.from_dict(_cfg_dict())
    port = port_build_model(cfg)
    wd = {id(p): g["weight_decay"] for g in make_optimizer(cfg.training, port).param_groups
          for p in g["params"]}
    named = dict(port.named_parameters())
    tables = [k for k in named if k.endswith("relative_position_bias_table")]
    assert len(tables) == 12
    assert all(wd[id(named[k])] == 0.0 for k in tables)
    assert all(wd[id(p)] == 0.01 for k, p in named.items() if k.endswith("attn.qkv.weight"))
    assert not any("relative_position_index" in k for k in port.state_dict())


def test_window_attention_matches_the_formula_with_a_shift_mask():
    """``window_attention``'s plain path on the windows of a 4×4 map padded
    to 6×6 (window 3, the padding's tokens projected like the others),
    rolled by one with its region mask, against
    ``softmax(QKᵀ/√d + bias)·V`` in f64: the output and the gradients of
    q, k, v and the bias within 1e-5 relative (f32 products; the softmax
    in f32)."""
    gen = torch.Generator().manual_seed(3)
    B, h, d, w = 2, 3, 8, WINDOW
    x = torch.nn.functional.pad(torch.randn((B, 4, 4, h * d), generator=gen), (0, 0, 0, 2, 0, 2))
    x = torch.roll(x, (-1, -1), (1, 2))
    win = swin.window_partition(x, w)  # [B·4, 9, C]
    Bw, N = win.shape[:2]
    proj = torch.randn((h * d, 3 * h * d), generator=gen) * 0.3
    q, k, v = (win @ proj + 0.2).view(Bw, N, 3, h, d).permute(2, 0, 3, 1, 4)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    table = torch.randn(((2 * w - 1) ** 2, h), generator=gen)
    mask = swin.shift_mask(6, 6, w, 1)
    assert mask.shape == (4, N, N) and (mask != 0).any()
    rel = table[swin.relative_position_index(w).reshape(-1)].view(N, N, h).permute(2, 0, 1)
    bias = (rel[None] + mask[:, None]).repeat(B, 1, 1, 1).requires_grad_()
    g = torch.randn((Bw, h, N, d), generator=gen)
    out = attention.window_attention(q, k, v, bias)
    out.backward(g)
    q2, k2, v2, b2 = (t.detach().double().requires_grad_() for t in (q, k, v, bias))
    want = torch.softmax(q2 @ k2.transpose(-1, -2) / d ** 0.5 + b2, dim=-1) @ v2
    want.backward(g.double())
    assert _rel(out.double(), want) < 1e-5
    for t, t2 in ((q, q2), (k, k2), (v, v2), (bias, b2)):
        assert _rel(t.grad.double(), t2.grad) < 1e-5


def test_the_shipped_swin_config_trains_and_predicts(tmp_path, capsys):
    """``configs/example-swin-upernet.yaml`` (64², batch 2, four images, the
    rest as shipped: Swin-T at window 7, drop path 0.2, UperNet at 512
    channels, AdamW with the warm-up, the clip, bf16) through ``python -m
    seghiero_torch.train`` on the CPU, then its checkpoint through
    ``Predictor``: masks of every level, in range."""
    with open(os.path.join(ROOT, "configs", "example-swin-upernet.yaml")) as f:
        d = copy.deepcopy(yaml.safe_load(f))
    d["dataset"]["synthetic_size"] = 4
    d["transform"]["resize"] = [HW, HW]
    d["training"].update(epochs=1, batch_size=2, num_workers=0)
    d["output"].update(checkpoint_dir=str(tmp_path))
    path = tmp_path / "swin.yaml"
    path.write_text(yaml.safe_dump(d))
    assert port_train_main(["--config", str(path), "--device", "cpu"]) == 0
    assert "Avg Val Loss" in capsys.readouterr().out
    cfg = PortConfig.from_dict(d)
    pred = Predictor.from_checkpoint(cfg, None, device="cpu")
    images = np.random.default_rng(0).integers(0, 255, (2, HW, HW, 3), dtype=np.uint8)
    masks = pred.predict_masks(images)
    assert set(masks) == {"fine", "coarse"}
    for lvl, (a, b) in pred.level_slices.items():
        m = masks[lvl]
        assert m.shape == (2, HW, HW) and int(m.min()) >= 0 and int(m.max()) < b - a
