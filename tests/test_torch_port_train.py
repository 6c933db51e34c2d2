"""The port's training path against the JAX package, on the CPU in f32.

* two SGD steps of ``train/steps.py:train_step`` against the JAX
  ``make_train_step`` from the same weights on the same batches (depth 18,
  narrow widths, 64², batch 4): per step the loss, every parameter, the
  momentum buffers, and the BatchNorm running statistics — which pins the
  flax (biased) running variance. The JAX side runs its XLA path (``pallas_fused_loss: false``;
  its depthwise falls back to the grouped conv on the CPU), the port its
  kernels' plain versions (``depthwise_backend: pallas``,
  ``pallas_fused_loss: true``). Batch 4, not 2: the ASPP image-pool
  branch normalizes one pooled value per image, and BatchNorm over 2 values
  outputs ±1 whatever its input — its input gradient is then rounding noise
  amplified by 1/σ, which reaches the whole backbone and differs between
  any two implementations.
* the synthetic dataset and the loader order, bit for bit;
* the metrics;
* checkpoint save / restore, and the ``python -m seghiero_torch.train``
  entry point on a tiny config (``--device cpu``; without it and without a
  card it raises).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from seghiero_torch.config import SegHieroConfig as PortConfig
from seghiero_torch.data.dataset import build_dataset as port_build_dataset
from seghiero_torch.data.pipeline import BatchLoader as PortLoader
from seghiero_torch.models.convert import (
    export_reference_checkpoint,
    load_reference_checkpoint,
    reference_checkpoint,
)
from seghiero_torch.models.segmenter import build_model as port_build_model
from seghiero_torch.train import metrics as port_metrics
from seghiero_torch.train.__main__ import main as port_train_main
from seghiero_torch.train.optim import make_optimizer as port_make_optimizer
from seghiero_torch.train.optim import schedule_fn
from seghiero_torch.train.steps import make_composite_loss as port_composite
from seghiero_torch.train.steps import train_step as port_train_step
from seghiero_torch.train.trainer import Trainer as PortTrainer
from seghiero_tpu.config import SegHieroConfig as JaxConfig
from seghiero_tpu.data.pipeline import BatchLoader as JaxLoader
from seghiero_tpu.data.synthetic import SyntheticShapesDataset as JaxSynthetic
from seghiero_tpu.models.segmenter import build_model as jax_build_model
from seghiero_tpu.train import metrics as jax_metrics
from seghiero_tpu.train.optim import make_optimizer as jax_make_optimizer
from seghiero_tpu.train.optim import make_schedule as jax_make_schedule
from seghiero_tpu.train.steps import TrainState
from seghiero_tpu.train.steps import make_composite_loss as jax_composite
from seghiero_tpu.train.steps import make_train_step as jax_make_train_step

CLASSES = {
    "coarse_to_fine_map": [[0, 3], [4, 6], [7], [8]],
    "coarse_names": {0: "a", 1: "b", 2: "c", 3: "d"},
    "fine_names": {i: f"f{i}" for i in range(9)},
}


def _cfg_dict(tmp, kernels=False, **training):
    return {
        "dataset": {"kind": "synthetic", "synthetic_size": 4},
        "classes": CLASSES,
        "model": {"depth": 18, "dtype": "float32", "aspp_channels": 16, "c1_channels": 8,
                  "proj_dim": 8, "dilations": [1, 2, 3, 4],
                  "depthwise_backend": "pallas" if kernels else "xla"},
        "training": {"epochs": 1, "batch_size": 2, "lr": 0.01, "momentum": 0.9,
                     "weight_decay": 1e-4, "pallas_fused_loss": kernels,
                     "hiera_precision": "parity", "num_workers": 0, **training},
        "transform": {"resize": [64, 64], "hflip_prob": 0.0},
        "output": {"checkpoint_dir": str(tmp), "project_name": "port"},
    }


def _batches(n):
    """Random images; labels planted at the four pixels the 64 → 2 nearest
    downsample reads (classes 1, 2 in coarse bucket 0; 4, 7 outside), so
    the triplet term is live on both sides, and an ignore block."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        images = rng.integers(0, 256, (4, 64, 64, 3)).astype(np.uint8)
        labels = rng.integers(0, 9, (4, 64, 64)).astype(np.int32)
        labels[:, 8:13, 8:13] = 255
        for lbl, (y, x) in zip((1, 2, 4, 7), ((0, 0), (0, 32), (32, 0), (32, 32))):
            labels[:, y, x] = lbl
        out.append((images, labels))
    return out


def _jax_variables(model, seed=0):
    # jitted: an eager init dispatches every layer's ops one by one
    init = jax.jit(lambda key, x: model.init(key, x, train=False))
    variables = init(jax.random.key(seed), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(seed)

    def randomize(path, leaf):  # non-trivial BN affine and statistics
        name, leaf = str(path[-1].key), np.asarray(leaf)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(randomize, jax.device_get(variables))


def test_two_sgd_steps_match_jax(tmp_path):
    jcfg = JaxConfig.from_dict(_cfg_dict(tmp_path))
    pcfg = PortConfig.from_dict(_cfg_dict(tmp_path, kernels=True))
    jmodel = jax_build_model(jcfg)
    variables = _jax_variables(jmodel)
    tx = jax_make_optimizer(jcfg.training)
    step_fn = jax.jit(jax_make_train_step(jmodel, jax_composite(jcfg), jcfg, tx))
    # the triplet ramp is 0 in f32 for the first steps: start mid-schedule
    # so the projection head trains on both sides
    start = 40_000
    state = TrainState(step=jnp.asarray(start, jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))

    model = port_build_model(pcfg)
    load_reference_checkpoint(model, export_reference_checkpoint(variables, 18))
    opt = port_make_optimizer(pcfg.training, model)
    composite = port_composite(pcfg)
    assert composite.use_kernel

    for step, (images, labels) in enumerate(_batches(2)):
        state, m = step_fn(state, {"image": jnp.asarray(images), "fine": jnp.asarray(labels)},
                           jnp.asarray(0))
        got = port_train_step(model, composite, opt, pcfg, {
            "image": torch.from_numpy(images), "fine": torch.from_numpy(labels)}, start + step)
        # f32 through 18 layers of train-mode BN in two frameworks
        np.testing.assert_allclose(float(got["loss"]), float(m["loss"]), rtol=1e-4)
        assert model.aspp_head.proj_head.proj[0].weight.grad.abs().max() > 0  # triplet live

        want = export_reference_checkpoint(jax.device_get(
            {"params": state.params, "batch_stats": state.batch_stats}), 18)
        trace = export_reference_checkpoint(jax.device_get(
            {"params": state.opt_state[1].trace, "batch_stats": state.batch_stats}), 18)
        have = reference_checkpoint(model)
        buffers = {name: opt.state[p]["momentum_buffer"] for name, p in model.named_parameters()}
        for part, attr in (("backbone_state_dict", "backbone"),
                           ("aspp_head_state_dict", "aspp_head"),
                           ("aux_head_state_dict", "aux_head")):
            for k, w in want[part].items():
                if k.endswith("num_batches_tracked"):
                    continue
                # parameters moved by one SGD step at lr 0.01: gradient
                # rounding differences reach them scaled by the learning
                # rate; running statistics within f32 rounding of the two
                # batch variances
                np.testing.assert_allclose(have[part][k].numpy(), w.numpy(), rtol=1e-4,
                                           atol=2e-5, err_msg=f"step {step}: {part}.{k}")
                if f"{attr}.{k}" in buffers:  # SGD's momentum buffer = optax's trace
                    b, t = buffers[f"{attr}.{k}"].numpy(), trace[part][k].numpy()
                    assert np.linalg.norm(b - t) <= 2e-3 * np.linalg.norm(t) + 1e-12, (
                        f"step {step}: momentum of {part}.{k}")
        # the biased running variance: torch's unbiased update would be off
        # by a factor n/(n−1) of the batch variance's share, far above this
        bn = have["backbone_state_dict"]["layer4.1.bn2.running_var"].numpy()
        np.testing.assert_allclose(bn, want["backbone_state_dict"]["layer4.1.bn2.running_var"]
                                   .numpy(), rtol=1e-5)
        # Each step starts from the JAX side's weights and statistics (the
        # momentum buffers carry over from the port's own step). This small
        # random-weight model is ill-conditioned: a 1e-6 relative change of
        # its weights moves its gradients by 0.1-2 %, so the ~1e-4 of an
        # update by which the two sides' weights differ after one step would
        # leave the second step's gradients about 1 % apart.
        load_reference_checkpoint(model, want)


def test_synthetic_dataset_and_loader_order_match_jax(tmp_path):
    jcfg = JaxConfig.from_dict(_cfg_dict(tmp_path))
    pcfg = PortConfig.from_dict(_cfg_dict(tmp_path))
    for split in ("train", "val"):
        jds = JaxSynthetic(jcfg, split=split, seed=3, size=5)
        pds = port_build_dataset(pcfg, split, seed=3)
        pds.size = 5
        for shuffle, drop_last in ((True, True), (False, False)):
            jl = JaxLoader(jds, 2, shuffle=shuffle, drop_last=drop_last, seed=3)
            pl = PortLoader(pds, 2, shuffle=shuffle, drop_last=drop_last, seed=3,
                            num_workers=2)
            for epoch in (0, 1):
                jl.set_epoch(epoch)
                pl.set_epoch(epoch)
                jb, pb = list(jl), list(pl)
                assert len(jb) == len(pb) == len(jl) == len(pl)
                for a, b in zip(jb, pb):
                    assert set(a) == set(b) == {"image", "fine", "coarse"}
                    for k in a:
                        np.testing.assert_array_equal(b[k].numpy(), a[k], err_msg=k)


def test_metrics_match_jax():
    rng = np.random.default_rng(4)
    preds = rng.integers(0, 5, (2, 30, 20)).astype(np.int32)
    labels = rng.integers(0, 5, (2, 30, 20)).astype(np.int32)
    labels[:, :4] = 255
    cm_j = np.array(jax_metrics.confusion_matrix(jnp.asarray(preds), jnp.asarray(labels), 5))
    cm_t = port_metrics.confusion_matrix(torch.from_numpy(preds), torch.from_numpy(labels), 5)
    np.testing.assert_array_equal(cm_t.numpy(), cm_j)
    c_j, v_j = jax_metrics.pixel_accuracy_counts(jnp.asarray(preds), jnp.asarray(labels))
    c_t, v_t = port_metrics.pixel_accuracy_counts(torch.from_numpy(preds),
                                                  torch.from_numpy(labels))
    assert (int(c_t), int(v_t)) == (int(c_j), int(v_j))
    cm_j[3] = 0  # a class absent from the truth
    for fn in ("per_class_iou", "miou_from_confusion", "macc_from_confusion"):
        np.testing.assert_array_equal(getattr(port_metrics, fn)(cm_j),
                                      getattr(jax_metrics, fn)(cm_j))
    acc_j = jax_metrics.SegMetrics({"fine": 5})
    acc_t = port_metrics.SegMetrics({"fine": 5})
    for acc in (acc_j, acc_t):
        acc.update(1.5, {"fine": {"cm": cm_j, "correct": 7, "valid": 9}})
    assert acc_t.summary() == acc_j.summary()


def test_lr_schedules_match_optax(tmp_path):
    for sched in ({"type": "poly", "warmup_steps": 3}, {"type": "cosine", "end_lr": 1e-4},
                  {"type": "constant", "warmup_steps": 2}):
        pcfg = PortConfig.from_dict(_cfg_dict(tmp_path, lr_schedule=sched)).training
        jcfg = JaxConfig.from_dict(_cfg_dict(tmp_path, lr_schedule=sched)).training
        ours, theirs = schedule_fn(pcfg, 20), jax_make_schedule(jcfg, 20)
        for count in range(0, 22):
            np.testing.assert_allclose(ours(count), float(theirs(count)), rtol=1e-6,
                                       atol=1e-12)


def test_checkpoint_round_trip(tmp_path):
    """Save after a train step, restore into a fresh Trainer: same weights,
    statistics, optimizer state and step, and the same eval loss bit for bit."""
    cfg = PortConfig.from_dict(_cfg_dict(tmp_path, kernels=True))
    tr = PortTrainer(cfg, device="cpu", verbose=False)
    batch = next(iter(tr.train_loader))
    port_train_step(tr.model, tr.composite, tr.optimizer, cfg, batch, 0)
    tr.step = 1
    val = tr.evaluate()
    tr.ckpt.save(tr.model, tr.optimizer, tr.scheduler, step=1, epoch=1, metrics=val,
                 best_val_loss=val["loss"], config_raw=cfg.raw, is_best=True)
    fresh = PortTrainer(cfg, device="cpu", verbose=False, resume=True)
    assert (fresh.step, fresh.start_epoch, fresh.best_val_loss) == (1, 1, val["loss"])
    for a, b in zip(tr.model.state_dict().values(), fresh.model.state_dict().values()):
        assert torch.equal(a, b)
    sa, sb = tr.optimizer.state_dict()["state"], fresh.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys() and all(
        torch.equal(sa[k]["momentum_buffer"], sb[k]["momentum_buffer"]) for k in sa)
    assert fresh.evaluate()["loss"] == val["loss"]
    assert fresh.ckpt.best_step() == 1
    ckpt = torch.load(tmp_path / "port" / "step_00000001" / "model.pth", weights_only=True)
    assert set(ckpt) == {"epoch", "backbone_state_dict", "aspp_head_state_dict",
                         "aux_head_state_dict"}


def test_train_entry_point_runs_a_tiny_config_on_cpu(tmp_path, capsys):
    d = _cfg_dict(tmp_path, kernels=True, log_every=1)
    d["output"]["metrics_jsonl"] = str(tmp_path / "m.jsonl")
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(d))
    assert port_train_main(["--config", str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Avg Val Loss" in out and "Saved new best model" in out
    assert (tmp_path / "port" / "step_00000002" / "model.pth").exists()
    assert len((tmp_path / "m.jsonl").read_text().splitlines()) == 1


def test_train_entry_point_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(_cfg_dict(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train_main(["--config", str(path)])


@pytest.mark.parametrize("key,value", [
    ("optimizer", "adamw"), ("fast_losses", False), ("grad_accum_steps", 2),
    ("ohem_thresh", 0.7), ("ema_decay", 0.99), ("extra_losses", [{"type": "dice"}]),
])
def test_unported_training_options_raise(tmp_path, key, value):
    cfg = PortConfig.from_dict(_cfg_dict(tmp_path, **{key: value}))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        PortTrainer(cfg, device="cpu", verbose=False)


def test_file_datasets_build_a_hiero_dataset(tmp_path):
    from PIL import Image

    from seghiero_torch.data.dataset import HieroDataset

    for sub, arr in (("i", np.zeros((8, 8, 3), np.uint8)), ("m", np.ones((8, 8), np.uint8))):
        (tmp_path / sub).mkdir()
        Image.fromarray(arr).save(tmp_path / sub / "a.png")
    d = copy.deepcopy(_cfg_dict(tmp_path))
    d["dataset"] = {"root": str(tmp_path), "train": {"image_subdir": "i", "mask_subdir": "m"}}
    ds = port_build_dataset(PortConfig.from_dict(d), "train")
    assert isinstance(ds, HieroDataset) and len(ds) == 1
    assert ds[0]["image"].shape == (64, 64, 3) and set(ds[0]) == {"image", "fine", "coarse"}
