"""The port's fine-tuning path against the JAX package, on the CPU.

* ``import_torchvision_backbone`` on a seeded torchvision-layout ResNet
  state dict: depth 18 through both backbones' forwards (f32, rtol 1e-4),
  depth 50 by its key map; the JAX import carried through the port's
  ``backbone_state_dict`` gives the same tensors;
* the optimizer (``backbone_lr_scale`` 0 and 0.1 under a poly schedule,
  ``wd_skip_norm_bias``, ``grad_clip_norm`` above and below the norm) on
  the same fixed gradients as optax's ``make_optimizer``: every update
  within 1e-6 of its norm, a frozen backbone's bits unchanged;
* ``device_hflip`` with injected coins against JAX's ``jnp.where``;
* a port ``Trainer`` on the CPU taking two steps from PNG files through
  the raw cache, from a ``.pth`` it wrote, with the flip on the device and
  all three optimizer options.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image
from torch import nn

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from seghiero_torch.config import SegHieroConfig as PortConfig
from seghiero_torch.config import TrainingConfig as PortTrainingConfig
from seghiero_torch.models.convert import backbone_state_dict as port_backbone_state_dict
from seghiero_torch.models.convert import import_torchvision_backbone as port_import
from seghiero_torch.models.resnet import ResNetBackbone as PortResNet
from seghiero_torch.models.segmenter import build_model as port_build_model
from seghiero_torch.train.optim import clip_grad_global_norm_
from seghiero_torch.train.optim import make_optimizer as port_make_optimizer
from seghiero_torch.train.optim import make_schedule as port_make_schedule
from seghiero_torch.train.steps import device_hflip, flip_coins, forward_losses
from seghiero_torch.train.steps import make_composite_loss as port_composite
from seghiero_torch.train.trainer import Trainer as PortTrainer
from seghiero_tpu.config import TrainingConfig as JaxTrainingConfig
from seghiero_tpu.models.resnet import ResNetBackbone as JaxResNet
from seghiero_tpu.models.torch_convert import import_torchvision_backbone as jax_import
from seghiero_tpu.train.optim import make_optimizer as jax_make_optimizer
from seghiero_tpu.train.optim import make_schedule as jax_make_schedule

CLASSES = {
    "coarse_to_fine_map": [[0, 3], [4, 6], [7], [8]],
    "coarse_names": {0: "a", 1: "b", 2: "c", 3: "d"},
    "fine_names": {i: f"f{i}" for i in range(9)},
}


def _torchvision_state_dict(depth, seed=0):
    """A seeded ResNet state dict in torchvision's names, classifier included."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in PortResNet(depth).state_dict().items():
        if v.dim() == 1 and k.endswith(("running_var", "weight")):  # BN scale, variance
            v = torch.rand(v.shape, generator=gen) + 0.5
        elif v.dim() == 1:  # BN shift, mean
            v = torch.randn(v.shape, generator=gen) * 0.1
        elif v.is_floating_point():  # conv kernels, lecun-normal
            v = torch.randn(v.shape, generator=gen) * v[0].numel() ** -0.5
        k = k.replace("stem_conv.", "conv1.").replace("stem_bn.", "bn1.")
        sd[k] = v
    width = 2048 if depth >= 50 else 512
    sd["fc.weight"] = torch.randn(1000, width, generator=gen)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def test_torchvision_import_depth18_forward_matches_jax():
    sd = _torchvision_state_dict(18)
    ours = PortResNet(18)
    ours.load_state_dict(port_import(sd, 18), strict=True)
    params, stats = jax_import(sd, 18)
    theirs = port_backbone_state_dict(params, stats, 18)
    mine = ours.state_dict()
    for k, v in theirs.items():
        assert torch.equal(mine[k], v), k
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(np.float32)
    apply = jax.jit(lambda v, x: JaxResNet(depth=18).apply(v, x, train=False))
    want = apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got = ours.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


def test_torchvision_import_depth50_key_map_matches_jax():
    sd = _torchvision_state_dict(50, seed=2)
    ours = port_import(sd, 50)
    theirs = port_backbone_state_dict(*jax_import(sd, 50), 50)
    assert set(ours) == set(theirs) == set(PortResNet(50).state_dict())
    for k, v in theirs.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(ours[k], v), k
    # the reference wrapper's stem names load the same; fc is dropped
    wrapper = {k.replace("conv1.", "stem_conv.", 1) if k.startswith("conv1.") else
               k.replace("bn1.", "stem_bn.", 1) if k.startswith("bn1.") else k: v
               for k, v in sd.items()}
    assert {k: v for k, v in port_import(wrapper, 50).items()}.keys() == ours.keys()
    with pytest.raises(ValueError, match="ResNet-50.*not the ResNet-101"):
        port_import(sd, 101)
    with pytest.raises(ValueError, match="ResNet-50.*not the ResNet-34"):
        port_import(sd, 34)


class _Tiny(nn.Module):
    """A backbone, a head with a classifier bias and an aux head — the
    parameter kinds of ``HieroSegmenter``, in a few hundred numbers."""

    def __init__(self):
        super().__init__()
        self.backbone = nn.Sequential(nn.Conv2d(3, 4, 3, bias=False), nn.BatchNorm2d(4))
        self.aspp_head = nn.Sequential(nn.Conv2d(4, 6, 1, bias=False), nn.BatchNorm2d(6),
                                       nn.Conv2d(6, 5, 1, bias=True))
        self.aux_head = nn.Sequential(nn.Conv2d(4, 2, 1, bias=False), nn.BatchNorm2d(2))


def _flax_paths(model):
    """Each parameter's flax path: conv weights are ``kernel`` leaves."""
    paths = []
    for name, mod in model.named_modules():
        top = name.split(".")[0]
        for pname, p in mod.named_parameters(recurse=False):
            leaf = "kernel" if isinstance(mod, nn.Conv2d) and pname == "weight" else (
                "scale" if pname == "weight" else "bias")
            paths.append((p, ("backbone" if top == "backbone" else "head", name, leaf)))
    return paths


def _nest(items):
    tree = {}
    for path, v in items:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


@pytest.mark.parametrize("scale,skip,clip,schedule", [
    (0.1, True, None, "poly"), (0.0, False, "below", "poly"),
    (0.1, False, "above", "poly"), (1.0, True, "below", None),
])
def test_optimizer_matches_optax(scale, skip, clip, schedule):
    rng = np.random.default_rng(7)
    model = _Tiny()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32) * 0.01))
    paths = _flax_paths(model)
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p, _ in paths]
             for _ in range(3)]
    norm0 = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads[0])))
    d = {"lr": 0.1, "momentum": 0.9, "weight_decay": 0.01, "backbone_lr_scale": scale,
         "wd_skip_norm_bias": skip,
         "grad_clip_norm": {None: None, "below": 0.5 * norm0, "above": 2.0 * norm0}[clip]}
    if schedule:
        d["lr_schedule"] = {"type": "poly", "power": 0.9}
    pcfg, jcfg = PortTrainingConfig.from_dict(d), JaxTrainingConfig.from_dict(d)
    opt = port_make_optimizer(pcfg, model)
    sched = port_make_schedule(pcfg, 5, opt)
    tx = jax_make_optimizer(jcfg, jax_make_schedule(jcfg, 5))
    # a copy: on the CPU jnp.asarray may share the buffer the port updates in place
    params = _nest((path, jnp.array(p.detach().numpy().copy())) for p, path in paths)
    state = tx.init(params)
    update = jax.jit(tx.update)  # eager optax dispatches op by op
    backbone0 = [p.detach().clone() for p in model.backbone.parameters()]
    for step, gs in enumerate(grads):
        before = [p.detach().numpy().astype(np.float64) for p, _ in paths]
        for (p, _), g in zip(paths, gs):
            p.grad = torch.from_numpy(g.copy())
        if pcfg.grad_clip_norm:
            clip_grad_global_norm_(model.parameters(), pcfg.grad_clip_norm)
        opt.step()
        if sched is not None:
            sched.step()
        updates, state = update(_nest((path, jnp.asarray(g)) for (_, path), g in
                                         zip(paths, gs)), state, params)
        params = optax.apply_updates(params, updates)
        for (p, path), b in zip(paths, before):
            want = np.asarray(updates[path[0]][path[1]][path[2]], np.float64)
            got = p.detach().numpy().astype(np.float64) - b
            err = np.linalg.norm(got - want)
            assert err <= 1e-6 * np.linalg.norm(want) + 1e-12, (step, path, err)
    if scale == 0.0:
        assert all(torch.equal(a, b) for a, b in zip(backbone0, model.backbone.parameters()))


def test_clip_is_exactly_one_below_the_limit():
    p = nn.Parameter(torch.ones(3))
    p.grad = torch.tensor([3.0, 4.0, 0.0])
    norm = clip_grad_global_norm_([p], 5.0)
    assert float(norm) == 5.0 and torch.equal(p.grad, torch.tensor([3.0, 4.0, 0.0]))
    clip_grad_global_norm_([p], 1.0)
    torch.testing.assert_close(p.grad, torch.tensor([0.6, 0.8, 0.0]), rtol=0, atol=1e-7)


def test_device_hflip_matches_jax_where():
    rng = np.random.default_rng(3)
    images = rng.standard_normal((3, 5, 7, 3)).astype(np.float32)
    fine = rng.integers(0, 9, (3, 5, 7)).astype(np.int32)
    coins = np.array([True, False, True])
    got_i, got_f = device_hflip(torch.from_numpy(images), torch.from_numpy(fine),
                                torch.from_numpy(coins))
    c = jnp.asarray(coins)
    want_i = jnp.where(c[:, None, None, None], jnp.asarray(images)[:, :, ::-1, :], images)
    want_f = jnp.where(c[:, None, None], jnp.asarray(fine)[:, :, ::-1], fine)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))


def _tiny_cfg_dict(tmp_path, **over):
    d = {
        "dataset": {"kind": "synthetic", "synthetic_size": 4},
        "classes": CLASSES,
        "model": {"depth": 18, "dtype": "float32", "aspp_channels": 16, "c1_channels": 8,
                  "proj_dim": 8, "dilations": [1, 2, 3, 4], "depthwise_backend": "pallas"},
        "training": {"epochs": 1, "batch_size": 2, "lr": 0.01, "momentum": 0.9,
                     "weight_decay": 1e-4, "pallas_fused_loss": True,
                     "hiera_precision": "parity", "num_workers": 0},
        "transform": {"resize": [64, 64], "hflip_prob": 1.0, "device_hflip": True},
        "output": {"checkpoint_dir": str(tmp_path), "project_name": "port"},
    }
    for section, kv in over.items():
        d[section] = {**d[section], **kv}
    return d


def test_flip_coins_and_the_flipped_step_loss(tmp_path):
    cfg = PortConfig.from_dict(_tiny_cfg_dict(tmp_path, transform={"hflip_prob": 0.5}))
    a, b = flip_coins(cfg, 3, 64, "cpu"), flip_coins(cfg, 3, 64, "cpu")
    assert a.dtype == torch.bool and a.shape == (64,) and torch.equal(a, b)
    assert not torch.equal(a, flip_coins(cfg, 4, 64, "cpu")) and 10 < int(a.sum()) < 54
    # hflip_prob 1: every coin true, so the flipped step's loss is the loss
    # of the batch flipped on the host with the device flip off
    cfg = PortConfig.from_dict(_tiny_cfg_dict(tmp_path))
    off = PortConfig.from_dict(_tiny_cfg_dict(tmp_path, transform={"device_hflip": False}))
    model, composite = port_build_model(cfg).train(), port_composite(cfg)
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)),
             "fine": torch.from_numpy(rng.integers(0, 9, (2, 64, 64)).astype(np.uint8))}
    flipped = {k: v.flip(2) for k, v in batch.items()}
    with torch.no_grad():
        loss = forward_losses(model, composite, cfg, batch, 0, flip_step=5)[0]
        want = forward_losses(model, composite, off, flipped, 0, flip_step=5)[0]
        plain = forward_losses(model, composite, cfg, batch, 0)[0]
    assert float(loss) == float(want) and float(loss) != float(plain)


def test_trainer_takes_two_steps_from_files_with_every_finetune_option(tmp_path):
    rng = np.random.default_rng(5)
    data = tmp_path / "data"
    for split, n in (("train", 4), ("val", 2)):
        for sub in ("img", "msk"):
            (data / split / sub).mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (72, 96, 3), dtype=np.uint8)).save(
                data / split / "img" / f"{i}.png")
            mask = rng.integers(0, 9, (72, 96)).astype(np.uint8)
            mask[:4, :4] = 255
            Image.fromarray(mask).save(data / split / "msk" / f"{i}.png")
    sd = _torchvision_state_dict(18, seed=4)
    torch.save(sd, tmp_path / "r18.pth")
    d = _tiny_cfg_dict(
        tmp_path,
        dataset={"kind": "files", "root": str(data), "cache": "raw",
                 "cache_dir": str(tmp_path / "cache"),
                 "train": {"image_subdir": "train/img", "mask_subdir": "train/msk"},
                 "val": {"image_subdir": "val/img", "mask_subdir": "val/msk"}},
        model={"pretrained": str(tmp_path / "r18.pth")},
        training={"backbone_lr_scale": 0.1, "wd_skip_norm_bias": True, "grad_clip_norm": 1.0},
        transform={"backend": "native", "scale_range": [0.5, 2.0], "color_jitter": 0.2,
                   "hflip_prob": 0.5})
    cfg = PortConfig.from_dict(copy.deepcopy(d))
    tr = PortTrainer(cfg, device="cpu", verbose=False)
    want = port_import(sd, 18)
    for k, v in tr.model.backbone.state_dict().items():
        assert torch.equal(v, want[k]), k
    batch = next(iter(tr.train_loader))
    assert set(batch) == {"image", "fine"} and batch["fine"].dtype == torch.uint8
    assert {"image", "fine", "coarse"} == set(next(iter(tr.val_loader)))
    groups = {(g["lr"], g["weight_decay"]) for g in tr.optimizer.param_groups}
    assert groups == {(0.001, 1e-4), (0.001, 0.0), (0.01, 1e-4), (0.01, 0.0)}
    history = tr.fit()
    assert tr.step == 2 and np.isfinite(history[0]["train_loss"])
    assert np.isfinite(history[0]["val_loss"])
    assert (tmp_path / "port" / "step_00000002" / "model.pth").exists()
    moved = [not torch.equal(v, want[k]) for k, v in tr.model.backbone.state_dict().items()
             if k.endswith("weight")]
    assert all(moved)


def test_pretrained_true_still_raises(tmp_path):
    cfg = PortConfig.from_dict(_tiny_cfg_dict(tmp_path, model={"pretrained": True}))
    with pytest.raises(ValueError, match="local weight file"):
        PortTrainer(cfg, device="cpu", verbose=False)
