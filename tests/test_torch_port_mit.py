"""SegFormer on the port (``backbone: mit``, ``head: segformer_mlp``,
``optimizer: adamw``) on the CPU, at a tiny size: MiT-B0, 64², batch 2.

* against the benchmark's plain reference (``hbench/reference/mit.py``,
  its AdamW ``hbench/reference/optim/adamw.py`` and its losses), one
  seeded state dict loaded into both: the forward's three outputs, the
  3-level loss and every parameter's gradient, three AdamW steps;
* against the JAX package: a JAX ``MiTBackbone`` + ``SegFormerMLPHead``
  with random BatchNorm statistics, carried into the port by
  ``models/convert.py``, the logits compared in f32;
* ``sr_attention`` against ``softmax(QKᵀ/√d)·V`` in f64 at each MiT
  stage's reduction and head count, forward and backward; the card
  kernels' backward arithmetic (``sr_attention_bwd_plain``) likewise, its
  query splits against one split, and the split chooser at MiT-B5's
  shapes;
* the shipped ``configs/example-mit-segformer.yaml`` through the train
  entry point for one tiny step and through ``Predictor``.

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
from hbench.reference import mit as ref_mit
from hbench.reference.losses import total_loss
from hbench.reference.optim import adamw as ref_adamw
from hbench.reference.train import normalize
from hbench.reference.tree import from_classes
from seghiero_torch.config import SegHieroConfig as PortConfig
from seghiero_torch.infer.predictor import Predictor
from seghiero_torch.models.convert import export_reference_checkpoint, load_reference_checkpoint
from seghiero_torch.models.segmenter import build_model as port_build_model
from seghiero_torch.ops import attention
from seghiero_torch.train.__main__ import main as port_train_main
from seghiero_torch.train.optim import (
    clip_grad_global_norm_,
    make_optimizer,
    make_schedule,
    schedule_fn,
)
from seghiero_torch.train.steps import forward_losses, make_composite_loss
from seghiero_tpu.config import SegHieroConfig as JaxConfig
from seghiero_tpu.models.segmenter import build_model as jax_build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, BATCH, SEED = 64, 2, 3_000_000_019
CLASSES_3L = {
    "super_coarse_to_coarse_map": [[0, 2], [3]],
    "super_coarse_names": {0: "x", 1: "y"},
    "coarse_to_fine_map": [[0, 3], [4, 6], [7], [8]],
    "coarse_names": {0: "a", 1: "b", 2: "c", 3: "d"},
    "fine_names": {i: f"f{i}" for i in range(9)},
}
TRAINING = {"batch_size": BATCH, "optimizer": "adamw", "lr": 1e-3, "backbone_lr_scale": 0.1,
            "weight_decay": 0.01, "wd_skip_norm_bias": True, "grad_clip_norm": 1.0,
            "hiera_precision": "parity", "rmi_precision": "parity", "rmi_backend": "xla"}


def _cfg_dict(dw_backend="xla", **training):
    return {
        "classes": CLASSES_3L,
        "model": {"backbone": "mit", "backbone_options": {"variant": "b0"},
                  "head": "segformer_mlp", "head_options": {"channels": 32, "dropout_rate": 0.0},
                  "proj_dim": 16, "dtype": "float32", "depthwise_backend": dw_backend},
        "training": dict(TRAINING, **training),
        "transform": {"resize": [HW, HW]},
    }


def _pair(d):
    """(port model, reference model, tree), both holding one seeded state dict."""
    tree = from_classes(d["classes"])
    sd = weights.make(ref_mit.build(d["model"], tree), SEED, "cpu", ref_mit.RESIDUAL_LAST)
    port = port_build_model(PortConfig.from_dict(d))
    port.load_state_dict(sd, strict=True)
    return port, weights.materialize(ref_mit.build(d["model"], tree), sd, "cpu"), tree


def _batches(n, tree):
    images, fine = scene.scenes(scene.generator(SEED, "cpu", stream=1), n * BATCH, (HW, HW),
                                tree.n_fine)
    return [{"image": images[i:i + BATCH], "fine": fine[i:i + BATCH].to(torch.int32)}
            for i in range(0, n * BATCH, BATCH)]


def _rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


@pytest.mark.parametrize("dw_backend", ["xla", "pallas"])
def test_forward_matches_the_plain_reference(dw_backend):
    """Both backends of the Mix-FFN's depthwise convolution (the kernels'
    plain version, ``F.conv2d``) against the reference's grouped conv, in
    train mode (batch statistics). Tolerance 1e-4 relative: f32 sums in
    other orders through 8 blocks and a flash-free attention."""
    d = _cfg_dict(dw_backend)
    port, ref, tree = _pair(d)
    port.train(), ref.train()
    x = normalize(_batches(1, tree)[0]["image"], {})
    with torch.no_grad():
        got, want = port(x), ref(x)
    assert set(got) == set(want) == {"logits", "embedding", "aux_logits"}
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert _rel(got[k], want[k]) < 1e-4, (k, _rel(got[k], want[k]))


def test_loss_and_every_gradient_match_the_plain_reference():
    """The port's 3-level composite (RMI, BCE, CE per level, tree triplet,
    aux CE) against the reference's ``total_loss``: the loss of each model
    within 1e-5 relative; the loss's gradient by each output, on the same
    outputs, within 1e-3 relative (RMI's log-determinants and their
    inverses in f32 amplify round-off: 1.5e-4 measured). Then that
    gradient carried back through both models: every parameter's gradient
    within 1e-5 of ``max(‖leaf‖, median leaf)`` (2e-6 measured; the
    median guards leaves whose gradient is round-off alone, such as a bias
    that a train-mode BatchNorm or a LayerNorm cancels)."""
    from seghiero_torch.losses.fast import aux_ce_fast

    d = _cfg_dict()
    port, ref, tree = _pair(d)
    port.train(), ref.train()
    cfg = PortConfig.from_dict(d)
    composite = make_composite_loss(cfg)
    fine = _batches(1, tree)[0]["fine"]
    x = normalize(_batches(1, tree)[0]["image"], {})

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
        assert _rel(leaves[k].grad, twins[k].grad) < 1e-3, k
    cot = {k: v.grad if v.grad is not None else torch.zeros_like(v) for k, v in twins.items()}
    sum((got[k] * cot[k]).sum() for k in cot).backward()
    sum((want[k] * cot[k]).sum() for k in cot).backward()
    pg = dict(port.named_parameters())
    norms = {k: float(p.grad.norm()) for k, p in ref.named_parameters() if p.grad is not None}
    med = sorted(norms.values())[len(norms) // 2]
    assert set(norms) == set(pg)
    for k, p in ref.named_parameters():
        assert float((pg[k].grad - p.grad).norm()) <= 1e-5 * max(norms[k], med), k


@pytest.mark.parametrize("schedule", [None, {"type": "poly", "power": 1.0, "warmup_steps": 2}])
def test_three_adamw_steps_match_the_reference_update(schedule):
    """Three updates of the port's optimizer (``make_optimizer``:
    ``torch.optim.AdamW`` over the parameter groups — the backbone at a
    tenth of the rate, decay on conv and linear weights only — with
    ``make_schedule`` and the global norm clip) against three of
    ``reference/optim/adamw.py``, from the same seeded parameters and the
    same gradients a step: the model's own at the first step, seeded ones
    after (a tenth of them near zero, where AdamW's ε acts). Every entry
    within 1e-5 of its change plus 16 f32 ulps of the largest value it can
    have passed (its first plus the three steps' learning rates: an Adam
    step is about lr an entry): two orders of
    the same arithmetic (torch decays, then adds the step; optax adds both
    at once), each rounding the parameter at every step (8 ulps measured)."""
    d = _cfg_dict(lr_schedule=schedule) if schedule else _cfg_dict()
    port, ref, tree = _pair(d)
    cfg = PortConfig.from_dict(d)
    p0 = {k: v.detach().clone() for k, v in port.named_parameters()}
    optimizer = make_optimizer(cfg.training, port)
    assert isinstance(optimizer, torch.optim.AdamW)
    scheduler = make_schedule(cfg.training, 10**9, optimizer)
    names = {id(p): k for k, p in port.named_parameters()}
    lr_of = {names[id(p)]: g.get("initial_lr", g["lr"]) for g in optimizer.param_groups
             for p in g["params"]}
    batch = _batches(1, tree)[0]
    loss, *_ = forward_losses(port, make_composite_loss(cfg), cfg, batch, 0)
    loss.backward()
    gen = torch.Generator().manual_seed(11)
    grads = [{k: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
              for k, p in port.named_parameters()}]
    for _ in range(2):
        grads.append({k: torch.randn(v.shape, generator=gen)
                      * torch.where(torch.rand(v.shape, generator=gen) < 0.1, 1e-9, 1e-2)
                      for k, v in p0.items()})
    params = dict(ref.named_parameters())
    state = {}
    for step, g in enumerate(grads):
        for k, p in port.named_parameters():
            p.grad = g[k].clone()
        clip_grad_global_norm_(port.parameters(), 1.0)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        norm = float(torch.sqrt(sum(v.double().square().sum() for v in g.values())))
        with torch.no_grad():
            ref_adamw.update(params, {k: v * (1.0 / max(norm, 1.0)) for k, v in g.items()},
                             state, d["training"], step)
    for k, p in port.named_parameters():
        change = params[k].detach() - p0[k]
        assert change.norm() > 0, k
        reach = p0[k].abs() + len(grads) * lr_of[k]
        tol = 1e-5 * change.abs() + 16 * torch.finfo(torch.float32).eps * reach
        assert ((p.detach() - params[k].detach()).abs() <= tol).all(), k


def test_adamw_groups_follow_the_jax_mask_and_the_schedule():
    """Decay on conv and linear weights only (the JAX package's
    ``_wd_mask``: kernels), the backbone at ``lr · backbone_lr_scale``,
    and the reference's schedule equal to the program's at each step."""
    d = _cfg_dict(lr_schedule={"type": "poly", "power": 1.0, "warmup_steps": 1500})
    cfg = PortConfig.from_dict(d)
    port = port_build_model(cfg)
    optimizer = make_optimizer(cfg.training, port)
    names = {id(p): n for n, p in port.named_parameters()}
    for g in optimizer.param_groups:
        for p in g["params"]:
            n = names[id(p)]
            assert g["weight_decay"] == (0.01 if p.ndim >= 2 else 0.0), n
            assert g["lr"] == pytest.approx(1e-4 if n.startswith("backbone.") else 1e-3), n
            assert g["eps"] == 1e-8 and g["betas"] == (0.9, 0.999)
    fn = schedule_fn(cfg.training, 10**9)
    for step in (0, 1, 2, 1499, 1500, 1501, 10**6):
        assert ref_adamw.schedule(d["training"], step) * 1e-3 == pytest.approx(fn(step),
                                                                                rel=1e-9)


@pytest.mark.parametrize("dw_backend", ["xla", "pallas"])
def test_logits_match_the_jax_package(dw_backend):
    """A JAX ``MiTBackbone`` (b0) + ``SegFormerMLPHead`` with random
    BatchNorm statistics and affines, carried into the port, eval mode, the
    same f32 images: logits within 2e-4 relative (XLA:CPU and oneDNN sum
    the convolutions, matmuls and LayerNorms in other orders; the JAX head
    resizes by two matmuls, the port by ``F.interpolate``)."""
    d = _cfg_dict(dw_backend)
    jmodel = jax_build_model(JaxConfig.from_dict(d))
    init = jax.jit(lambda key, x: jmodel.init(key, x, train=False))
    variables = jax.device_get(init(jax.random.key(7), jnp.zeros((1, HW, HW, 3))))
    rng = np.random.default_rng(7)

    def randomize(path, leaf):
        name, leaf = str(path[-1].key), np.asarray(leaf)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
        return leaf

    variables = jax.tree_util.tree_map_with_path(randomize, variables)
    port = port_build_model(PortConfig.from_dict(d))
    load_reference_checkpoint(port, export_reference_checkpoint(variables, 0,
                                                                mit_variant="b0"))
    port.eval()
    x = np.random.default_rng(8).standard_normal((BATCH, HW, HW, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, x)
                      ["logits"]).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2), outputs=("logits",))["logits"]
    assert got.shape == want.shape
    assert np.linalg.norm(got.numpy() - want) <= 2e-4 * np.linalg.norm(want)


@pytest.mark.parametrize("stage", range(4))
def test_sr_attention_matches_softmax_qk_v(stage):
    """At MiT-B0's stage ``stage`` of a 64² image (its head count and the
    key count its ``sr`` leaves), forward and backward against the formula
    in f64: within 1e-5 relative (f32 products; the softmax in f32)."""
    heads, sr = ref_mit.NUM_HEADS[stage], ref_mit.SR_RATIOS[stage]
    side = HW // 4 >> stage
    N, M, dim = side * side, (side // sr) ** 2, ref_mit.VARIANTS["b0"][1][stage]
    gen = torch.Generator().manual_seed(stage)
    q, k, v = (torch.randn((BATCH, heads, n, dim // heads), generator=gen).requires_grad_()
               for n in (N, M, M))
    g = torch.randn((BATCH, heads, N, dim // heads), generator=gen)
    out = attention.sr_attention(q, k, v)
    out.backward(g)
    q2, k2, v2 = (t.detach().double().requires_grad_() for t in (q, k, v))
    want = torch.softmax(q2 @ k2.transpose(-1, -2) / (dim // heads) ** 0.5, dim=-1) @ v2
    want.backward(g.double())
    assert _rel(out.double(), want) < 1e-5
    for t, t2 in ((q, q2), (k, k2), (v, v2)):
        assert _rel(t.grad.double(), t2.grad) < 1e-5


def _attention_operands(seed, B, heads, N, M, d):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn((B, heads, n, d), generator=gen) for n in (N, M, M, N)]


@pytest.mark.parametrize("stage", range(4))
def test_sr_attention_bwd_mirror_matches_softmax_qk_v(stage):
    """The hand-written pair's backward arithmetic (``sr_attention_bwd_plain``:
    the saved log-sum-exp, D, the query splits the shape gets) at MiT-B0's
    stage ``stage`` of a 64² image against the formula's gradients in f64:
    within 1e-5 relative (f32 products)."""
    heads, sr = ref_mit.NUM_HEADS[stage], ref_mit.SR_RATIOS[stage]
    side = HW // 4 >> stage
    N, M, dim = side * side, (side // sr) ** 2, ref_mit.VARIANTS["b0"][1][stage]
    q, k, v, g = _attention_operands(10 + stage, BATCH, heads, N, M, dim // heads)
    o = attention.sr_attention_plain(q, k, v)
    splits = attention.backward_splits(BATCH, heads, N, M)
    got = attention.sr_attention_bwd_plain(q, k, v, o, attention.sr_attention_lse(q, k), g, splits)
    q2, k2, v2 = (t.double().requires_grad_() for t in (q, k, v))
    want = torch.softmax(q2 @ k2.transpose(-1, -2) / (dim // heads) ** 0.5, dim=-1) @ v2
    want.backward(g.double())
    for t, t2 in zip(got, (q2, k2, v2)):
        assert _rel(t.double(), t2.grad) < 1e-5


@pytest.mark.parametrize("splits", (1, 3, 16))
def test_sr_attention_bwd_mirror_splits_agree(splits):
    """dk and dv summed over ``splits`` query splits, in the kernel's order,
    agree with one split within 1e-5 relative (f32 sums in another order),
    at a shape whose queries and keys end in ragged tiles (17 tiles of 64
    queries, the last of 5 rows; 70 keys); dq does not depend on them."""
    q, k, v, g = _attention_operands(7, 2, 3, 16 * attention.TILE + 5, 70, 32)
    o = attention.sr_attention_plain(q, k, v)
    lse = attention.sr_attention_lse(q, k)
    one = attention.sr_attention_bwd_plain(q, k, v, o, lse, g, 1)
    got = attention.sr_attention_bwd_plain(q, k, v, o, lse, g, splits)
    assert torch.equal(got[0], one[0])
    for t, t1 in zip(got[1:], one[1:]):
        assert _rel(t, t1) < 1e-5


def test_split_chooser_fills_the_card_at_mitb5_and_stays_within_the_tiles():
    """At MiT-B5's four stage shapes of a 1024² image at batch 1 (M = 1 024
    keys, heads 1/2/5/8), the dk/dv grid has at least one block per SM; at
    those and other shapes the splits are at least 1 and at most the query
    tiles, and their bounds cover the rows once, in order. The forward
    takes two warpgroups a block where that leaves no SM more work."""
    for stage, heads in enumerate(ref_mit.NUM_HEADS):
        N = (1024 // 4 >> stage) ** 2
        s = attention.backward_splits(1, heads, N, 1024)
        assert -(-1024 // attention.TILE) * heads * s >= attention.SMS, (stage, s)
        # the forward's blocks: 128 queries at the first two stages (512 and
        # 256 blocks), 64 where 128 would load some SMs twice (160, 64 blocks)
        assert attention.forward_rows(1, heads, N) == (128, 128, 64, 64)[stage], stage
    for B, heads, N, M in ((1, 1, 65536, 1024), (2, 5, 4096, 1024), (1, 8, 1024, 1024),
                           (2, 1, 256, 4), (2, 8, 4, 4), (1, 1, 1, 1), (8, 8, 64, 4096)):
        s = attention.backward_splits(B, heads, N, M)
        assert 1 <= s <= -(-N // attention.TILE), (B, heads, N, M, s)
        bounds = attention.split_bounds(N, s)
        assert bounds[0][0] == 0 and bounds[-1][1] == N
        assert all(a[1] == b[0] and a[0] <= a[1] for a, b in zip(bounds, bounds[1:]))


def test_attention_tile_is_the_kernels():
    """``ops/attention.py`` reckons its splits with the tile of
    csrc/sr_attention.cu (``constexpr int kTile``): queries a block of the
    backward's dq launch and of each split's streamed tiles, keys a block
    of its dk/dv launch."""
    import re

    path = os.path.join(ROOT, "seghiero_torch", "csrc", "sr_attention.cu")
    with open(path) as f:
        tile = int(re.search(r"constexpr int kTile = (\d+);", f.read()).group(1))
    assert attention.TILE == tile


def _example_cfg(tmp_path):
    with open(os.path.join(ROOT, "configs", "example-mit-segformer.yaml")) as f:
        d = yaml.safe_load(f)
    d = copy.deepcopy(d)
    d["model"]["backbone_options"]["variant"] = "b0"
    d["dataset"]["synthetic_size"] = 4
    d["transform"]["resize"] = [HW, HW]
    d["training"].update(epochs=1, batch_size=2, num_workers=0)
    d["output"].update(checkpoint_dir=str(tmp_path))
    return d


def test_the_shipped_segformer_config_trains_and_predicts(tmp_path, capsys):
    """``configs/example-mit-segformer.yaml`` (variant b0, 64², batch 2, the
    rest as shipped: AdamW, the warm-up, drop path and dropout 0.1, the
    clip, bf16) through ``python -m seghiero_torch.train`` on the CPU, then
    its checkpoint through ``Predictor``: masks of every level, in range."""
    d = _example_cfg(tmp_path)
    path = tmp_path / "mit.yaml"
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
