"""ViT + UperNet on the port (``backbone: vit``, ``head: upernet``,
``optimizer: adamw``) on the CPU, at a tiny size: ViT-tiny (192 wide, 12
blocks, 3 heads of 64) with patch 16 at 64², a 4×4 grid of patch tokens
after the CLS token and 2 register tokens, the position table's 2×2
pretraining grid resized to 4×4, LayerScale on, batch 2. Every option of
the JAX package's ``ViTBackbone`` is crossed.

* against the JAX package: a JAX ``ViTBackbone`` + ``UPerNetHead`` with
  random weights, norms and BatchNorm statistics, carried into the port by
  ``models/convert.py``: logits, embedding and aux logits in f32;
* against the benchmark's plain reference (``hbench/reference/vit.py``,
  its AdamW ``hbench/reference/optim/adamw.py`` and its losses), one
  seeded state dict loaded into both: the forward's three outputs, the
  2-level loss and every parameter's gradient (``pos_embed``'s,
  ``cls_token``'s and the registers' included), three AdamW steps;
* the position table's resize against the JAX package's cubic matrices and
  ``F.interpolate``'s bicubic at a non-square grid (3×3 → 5×7);
* the tokens in AdamW's group without decay, the deconvolutions decayed;
* the shipped ``configs/example-vit-upernet.yaml`` through the train
  entry point for one tiny epoch and through ``Predictor``.

Every comparison is in f32; each tolerance is written beside its reason.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from hbench.core import scene, weights
from hbench.reference import vit as ref_vit
from hbench.reference.losses import total_loss
from hbench.reference.optim import adamw as ref_adamw
from hbench.reference.train import normalize
from hbench.reference.tree import from_classes
from seghiero_torch.config import SegHieroConfig as PortConfig
from seghiero_torch.infer.predictor import Predictor
from seghiero_torch.models import vit
from seghiero_torch.models.convert import export_reference_checkpoint, load_reference_checkpoint
from seghiero_torch.models.segmenter import build_model as port_build_model
from seghiero_torch.train.__main__ import main as port_train_main
from seghiero_torch.train.optim import make_optimizer, make_schedule
from seghiero_torch.train.steps import forward_losses, make_composite_loss
from seghiero_tpu.config import SegHieroConfig as JaxConfig
from seghiero_tpu.models import vit as jax_vit
from seghiero_tpu.models.segmenter import build_model as jax_build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, BATCH, SEED = 64, 2, 3_000_000_019
CLASSES_2L = {
    "coarse_to_fine_map": [[0, 3], [4, 6], [7]],
    "coarse_names": {0: "a", 1: "b", 2: "c"},
    "fine_names": {i: f"f{i}" for i in range(8)},
}
TRAINING = {"batch_size": BATCH, "optimizer": "adamw", "lr": 1e-3, "weight_decay": 0.01,
            "wd_skip_norm_bias": True, "hiera_precision": "parity"}
BACKBONE = {"variant": "tiny", "patch": 16, "pos_grid": 2, "n_register": 2,
            "layer_scale_init": 0.5}
TOKENS = ("backbone.cls_token", "backbone.reg_token", "backbone.pos_embed")


def _cfg_dict(**training):
    return {
        "classes": CLASSES_2L,
        "model": {"backbone": "vit", "backbone_options": dict(BACKBONE),
                  "head": "upernet", "head_options": {"channels": 32, "dropout_rate": 0.0},
                  "proj_dim": 16, "dtype": "float32"},
        "training": dict(TRAINING, **training),
        "transform": {"resize": [HW, HW]},
    }


def _pair(d):
    """(port model, reference model, tree), both holding one seeded state dict."""
    tree = from_classes(d["classes"])
    sd = weights.make(ref_vit.build(d["model"], tree), SEED, "cpu", ref_vit.RESIDUAL_LAST)
    port = port_build_model(PortConfig.from_dict(d))
    port.load_state_dict(sd, strict=True)
    return port, weights.materialize(ref_vit.build(d["model"], tree), sd, "cpu"), tree


def _batch(tree):
    images, fine = scene.scenes(scene.generator(SEED, "cpu", stream=1), BATCH, (HW, HW),
                                tree.n_fine)
    return {"image": images, "fine": fine.to(torch.int32)}


def _rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def test_outputs_match_the_jax_package():
    """A JAX ViT-tiny (pos grid 2 → 4, 2 registers, LayerScale) + UPerNet
    with random weights (normal kernels at 1/√fan_in, tokens and
    LayerScale at 0.1, LayerNorm and BatchNorm scales in 0.5–1.5, shifts,
    biases and means at 0.1, variances in 0.5–1.5), carried into the port
    (the deconvolution kernels flipped), eval mode, the same f32 images:
    the logits, embedding and aux logits each within 1e-5 relative (XLA:CPU
    and oneDNN sum the matmuls, convolutions and LayerNorms in other
    orders through 12 blocks and UperNet). The variables' shapes come from
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
        return rng.standard_normal(shape).astype(np.float32) * 0.1

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    port = port_build_model(PortConfig.from_dict(d))
    load_reference_checkpoint(port, export_reference_checkpoint(variables, 0, vit_variant="tiny"))
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
    output within 1e-5 relative (6e-7 measured: f32 sums in other orders
    through 12 blocks, the pyramid's deconvolutions as convolutions against
    the reference's matrix products, and UperNet)."""
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
    through both models (the reference's blocks recomputed in the backward
    by ``torch.utils.checkpoint``): every parameter's gradient, the
    position table's (through the resize), the CLS token's and the
    registers' among them, within 2e-4 of ``max(‖leaf‖, median leaf)``
    (the median guards leaves whose gradient is round-off alone, such as a
    bias that a train-mode BatchNorm cancels, or the 1×1 pool's
    convolution, whose BatchNorm normalizes two values a channel)."""
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
    assert all(norms[k] > 0 for k in TOKENS)
    for k, p in ref.named_parameters():
        want_g = p.grad.reshape(pg[k].shape)
        assert float((pg[k].grad - want_g).norm()) <= 2e-4 * max(norms[k], med), k


def test_three_adamw_steps_match_the_reference_update():
    """Three updates of the port's optimizer (AdamW over the parameter
    groups, decay on conv, deconvolution and linear weights only, the
    warm-up schedule) against three of ``reference/optim/adamw.py`` from
    the same seeded parameters and the same gradients a step (the model's
    own first, seeded ones after): every entry within 1e-5 of its change
    plus 16 f32 ulps of the largest value it can have passed, as in the
    SegFormer test; the tokens, held flat in the reference so that it
    decays them no more than the program does, move alike."""
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


def test_tokens_are_not_decayed_and_the_deconvolutions_are():
    """Under ``wd_skip_norm_bias`` the CLS, register and position tokens and
    the LayerScale gammas sit in AdamW's group without decay, as the JAX
    package's ``_wd_mask`` (flax ``kernel`` leaves only) and mmseg's
    ``decay_mult=0``; the pyramid's deconvolution and the ``qkv`` weights
    are decayed."""
    cfg = PortConfig.from_dict(_cfg_dict())
    port = port_build_model(cfg)
    wd = {id(p): g["weight_decay"] for g in make_optimizer(cfg.training, port).param_groups
          for p in g["params"]}
    named = dict(port.named_parameters())
    undecayed = [k for k in named if k in TOKENS or k.endswith(".gamma")]
    assert len(undecayed) == 3 + 2 * 12
    assert all(wd[id(named[k])] == 0.0 for k in undecayed)
    decayed = [k for k in named if k.startswith(("backbone.fpn", "backbone.blocks.0.attn.qkv"))
               and k.endswith(".weight") and named[k].ndim > 1]
    assert len(decayed) == 4 and all(wd[id(named[k])] == 0.01 for k in decayed)


def test_position_resize_matches_the_jax_cubic_matrix_on_a_non_square_grid():
    """The port's and the reference's cubic matrices (3 → 5, 3 → 7) against
    the JAX package's ``_cubic_resize_matrix`` within 1e-6 (the JAX
    matrix sums its clamped taps in f32, the others in f64), and a 3×3
    table resized to 5×7 by the port, by the JAX package's
    ``interpolate_pos_embed`` and by ``F.interpolate(mode="bicubic")``
    within 1e-5 relative, the CLS slot unchanged."""
    for n_out in (5, 7):
        want = jax_vit._cubic_resize_matrix(3, n_out)
        for got in (vit.cubic_resize_matrix(3, n_out), ref_vit.cubic_matrix(3, n_out, "cpu")):
            assert np.abs(got.numpy() - want).max() <= 1e-6, n_out
    pos = torch.randn((1, 1 + 9, 6), generator=torch.Generator().manual_seed(4))
    got = vit.resize_pos_embed(pos, (3, 3), (5, 7))
    want = np.asarray(jax_vit.interpolate_pos_embed(jnp.asarray(pos.numpy()), (3, 3), (5, 7)))
    lib = torch.nn.functional.interpolate(pos[0, 1:].reshape(1, 3, 3, 6).permute(0, 3, 1, 2),
                                          size=(5, 7), mode="bicubic", align_corners=False)
    assert got.shape == (1, 1 + 35, 6) and torch.equal(got[:, 0], pos[:, 0])
    assert _rel(got, torch.from_numpy(np.array(want))) < 1e-5
    assert _rel(got[0, 1:], lib[0].permute(1, 2, 0).reshape(35, 6)) < 1e-5


def test_the_shipped_vit_config_trains_and_predicts(tmp_path, capsys):
    """``configs/example-vit-upernet.yaml`` (ViT-tiny at 64², batch 2, four
    images, the rest as shipped: patch 16 with the 14×14 table resized to
    4×4, drop path 0.1, UperNet at 512 channels, AdamW with the warm-up,
    the clip, bf16) through ``python -m seghiero_torch.train`` on the CPU,
    then its checkpoint through ``Predictor``: masks of every level, in
    range."""
    with open(os.path.join(ROOT, "configs", "example-vit-upernet.yaml")) as f:
        d = copy.deepcopy(yaml.safe_load(f))
    d["model"]["backbone_options"]["variant"] = "tiny"
    d["dataset"]["synthetic_size"] = 4
    d["transform"]["resize"] = [HW, HW]
    d["training"].update(epochs=1, batch_size=2, num_workers=0)
    d["output"].update(checkpoint_dir=str(tmp_path))
    path = tmp_path / "vit.yaml"
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


def test_a_batch_of_one_image_trains_as_the_jax_package_and_the_reference():
    """At one image a batch (the cell's), UperNet's 1×1 pool leaves its
    BatchNorm one value a channel, which ``nn.BatchNorm2d`` refuses in
    train mode. The port's BatchNorm follows flax's ``nn.BatchNorm``
    there: the output is the shift (exactly), the running mean moves
    toward the value (within 3e-8, f32 rounding of the two updates) and
    the variance toward 0, and the input and scale get no gradient. Then
    the whole model at batch 1 in train mode against the plain reference,
    whose pooling branches normalize such a map by hand: each output
    within 1e-5 relative, every gradient within 2e-4 of ``max(‖leaf‖,
    median leaf)``, the pooled branch's convolution's gradient 0 in both."""
    import flax.linen as fnn

    from seghiero_torch.models.resnet import batch_norm

    rng = np.random.default_rng(5)
    C = 6
    x = rng.standard_normal((1, 1, 1, C)).astype(np.float32)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
                    "bias": rng.standard_normal(C).astype(np.float32)},
         "batch_stats": {"mean": rng.standard_normal(C).astype(np.float32),
                         "var": rng.uniform(0.5, 1.5, C).astype(np.float32)}}
    y, upd = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5).apply(
        v, x, mutable=["batch_stats"])
    bn = batch_norm(C).train()
    with torch.no_grad():
        for name, val in (("weight", "scale"), ("bias", "bias")):
            getattr(bn, name).copy_(torch.from_numpy(v["params"][val]))
        bn.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    out = bn(xt)
    assert np.array_equal(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y))
    assert np.abs(bn.running_mean.numpy() - np.asarray(upd["batch_stats"]["mean"])).max() < 3e-8
    assert np.allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]), 0, 1e-7)
    out.sum().backward()
    assert not xt.grad.any() and not bn.weight.grad.any()

    d = _cfg_dict(batch_size=1)
    port, ref, tree = _pair(d)
    port.train(), ref.train()
    x = normalize(_batch(tree)["image"][:1], {})
    got, want = port(x), ref(x)
    for k in want:
        assert _rel(got[k], want[k]) < 1e-5, k
    sum(v.sum() for v in got.values()).backward()
    sum(v.sum() for v in want.values()).backward()
    pg = dict(port.named_parameters())
    norms = {k: float(p.grad.norm()) for k, p in ref.named_parameters()}
    med = sorted(norms.values())[len(norms) // 2]
    for k, p in ref.named_parameters():
        assert float((pg[k].grad - p.grad.reshape(pg[k].shape)).norm()) <= 2e-4 * max(
            norms[k], med), k
    pooled = "aspp_head.psp_modules.0.0.weight"
    assert norms[pooled] == 0 and not pg[pooled].grad.any()
