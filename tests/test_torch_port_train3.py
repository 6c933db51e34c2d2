"""The port's 3-level training path against the JAX package, on the CPU in f32.

* one SGD step of ``train/steps.py:train_step`` against the JAX
  ``make_train_step`` from the same weights on the same batch (depth 18,
  narrow widths, 64², batch 4, 15 classes): the loss, every parameter and
  the BatchNorm statistics. The JAX side runs its XLA path (materialized
  RMI; its depthwise falls back to the grouped conv on the CPU), the port
  its kernels' plain versions (``depthwise_backend: pallas``,
  ``rmi_backend: pallas``) — so the weight carry (``models/convert.py``)
  is exercised at 15 classes too;
* the composite's dispatch: λ = ``training.fine_weight`` with a loss weight
  of 1, the 60k-step schedule, the one-sided-split warning;
* ``python -m seghiero_torch.train --device cpu`` on a tiny 3-level config:
  the super level in the printout, the tables and a checkpoint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from seghiero_torch.config import SegHieroConfig as PortConfig
from seghiero_torch.models.convert import (
    export_reference_checkpoint,
    load_reference_checkpoint,
    reference_checkpoint,
)
from seghiero_torch.models.segmenter import build_model as port_build_model
from seghiero_torch.train.__main__ import main as port_train_main
from seghiero_torch.train.optim import make_optimizer as port_make_optimizer
from seghiero_torch.train.steps import eval_step as port_eval_step
from seghiero_torch.train.steps import make_composite_loss as port_composite
from seghiero_torch.train.steps import train_step as port_train_step
from seghiero_tpu.config import SegHieroConfig as JaxConfig
from seghiero_tpu.models.segmenter import build_model as jax_build_model
from seghiero_tpu.train.optim import make_optimizer as jax_make_optimizer
from seghiero_tpu.train.steps import TrainState
from seghiero_tpu.train.steps import make_composite_loss as jax_composite
from seghiero_tpu.train.steps import make_train_step as jax_make_train_step

CLASSES_3L = {
    "super_coarse_to_coarse_map": [[0, 2], [3]],
    "super_coarse_names": {0: "x", 1: "y"},
    "coarse_to_fine_map": [[0, 3], [4, 6], [7], [8]],
    "coarse_names": {0: "a", 1: "b", 2: "c", 3: "d"},
    "fine_names": {i: f"f{i}" for i in range(9)},
}


def _cfg_dict(tmp, kernels=False, classes=CLASSES_3L, **training):
    return {
        "dataset": {"kind": "synthetic", "synthetic_size": 4},
        "classes": classes,
        "model": {"depth": 18, "dtype": "float32", "aspp_channels": 16, "c1_channels": 8,
                  "proj_dim": 8, "dilations": [1, 2, 3, 4],
                  "depthwise_backend": "pallas" if kernels else "xla"},
        "training": {"epochs": 1, "batch_size": 2, "lr": 0.01, "momentum": 0.9,
                     "weight_decay": 1e-4, "rmi_backend": "pallas" if kernels else "xla",
                     "hiera_precision": "parity", "num_workers": 0, **training},
        "transform": {"resize": [64, 64], "hflip_prob": 0.0},
        "output": {"checkpoint_dir": str(tmp), "project_name": "port3"},
    }


def _batch():
    """Random images; labels with an ignore block and, at the four pixels
    the 64 → 2 nearest downsample reads, classes 1 and 2 (upper triplet
    group) and 8 (lower), so the group triplet is live."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (4, 64, 64, 3)).astype(np.uint8)
    labels = rng.integers(0, 9, (4, 64, 64)).astype(np.int32)
    labels[:, 8:13, 8:13] = 255
    for lbl, (y, x) in zip((1, 2, 8, 4), ((0, 0), (0, 32), (32, 0), (32, 32))):
        labels[:, y, x] = lbl
    return images, labels


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


def test_one_sgd_step_matches_jax(tmp_path):
    jcfg = JaxConfig.from_dict(_cfg_dict(tmp_path))
    pcfg = PortConfig.from_dict(_cfg_dict(tmp_path, kernels=True))
    jmodel = jax_build_model(jcfg)
    variables = _jax_variables(jmodel)
    tx = jax_make_optimizer(jcfg.training)
    step_fn = jax.jit(jax_make_train_step(jmodel, jax_composite(jcfg), jcfg, tx))
    start = 30_000  # mid-schedule (60k steps): the triplet term is live
    state = TrainState(step=jnp.asarray(start, jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    model = port_build_model(pcfg)
    load_reference_checkpoint(model, export_reference_checkpoint(variables, 18))
    opt = port_make_optimizer(pcfg.training, model.parameters())
    composite = port_composite(pcfg)
    assert composite.rmi_backend == "pallas"

    images, labels = _batch()
    state, m = step_fn(state, {"image": jnp.asarray(images), "fine": jnp.asarray(labels)},
                       jnp.asarray(0))
    got = port_train_step(model, composite, opt, pcfg, {
        "image": torch.from_numpy(images), "fine": torch.from_numpy(labels)}, start)
    # f32 through 18 layers of train-mode BN in two frameworks
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]), rtol=1e-4)
    assert model.aspp_head.proj_head.proj[0].weight.grad.abs().max() > 0  # triplet live
    want = export_reference_checkpoint(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}), 18)
    have = reference_checkpoint(model)
    for part in ("backbone_state_dict", "aspp_head_state_dict", "aux_head_state_dict"):
        for k, w in want[part].items():
            if k.endswith("num_batches_tracked"):
                continue
            # one SGD step at lr 0.01: the gradients' rounding differences
            # (RMI's logdet amplifies them, tests/test_torch_port_rmi.py)
            # reach the parameters scaled by the learning rate
            np.testing.assert_allclose(have[part][k].numpy(), w.numpy(), rtol=1e-4, atol=2e-5,
                                       err_msg=f"{part}.{k}")
    assert want["aspp_head_state_dict"]["cls_seg.weight"].shape[0] == 15


def test_composite_dispatch_matches_jax(tmp_path):
    d = _cfg_dict(tmp_path, fine_weight=0.7, triplet_selection="sorted")
    jc, pc = jax_composite(JaxConfig.from_dict(d)), port_composite(PortConfig.from_dict(d))
    for attr in ("loss_weight_lambda", "loss_weight", "schedule_total_steps", "rmi_radius",
                 "upper_ids", "lower_ids", "selection"):
        assert getattr(pc, attr) == getattr(jc, attr), attr
    assert (pc.loss_weight_lambda, pc.loss_weight, pc.schedule_total_steps) == (0.7, 1.0, 60_000)
    # background 0 alone in super 0, every other fine class in super 1: the
    # derived split has no lower group
    one_sided = {"super_coarse_to_coarse_map": [[0], [1, 2]], "super_coarse_names": {0: "x", 1: "y"},
                 "coarse_to_fine_map": [[0], [1, 3], [4, 6]],
                 "coarse_names": {0: "a", 1: "b", 2: "c"},
                 "fine_names": {i: f"f{i}" for i in range(7)}}
    cfg = PortConfig.from_dict(_cfg_dict(tmp_path, classes=one_sided))
    assert cfg.hierarchy.split_upper_lower() == ((1, 2, 3, 4, 5, 6), ())
    with pytest.warns(UserWarning, match="one-sided"):
        port_composite(cfg)


def test_eval_step_reports_the_super_level(tmp_path):
    cfg = PortConfig.from_dict(_cfg_dict(tmp_path, kernels=True))
    model = port_build_model(cfg)
    images, labels = _batch()
    h = cfg.hierarchy
    batch = {"image": torch.from_numpy(images), "fine": torch.from_numpy(labels),
             "coarse": torch.from_numpy(h.map_fine_labels(labels, "coarse")),
             "super": torch.from_numpy(h.map_fine_labels(labels, "super"))}
    out = port_eval_step(model, port_composite(cfg), cfg, batch, 0)
    assert set(out["levels"]) == {"fine", "coarse", "super"}
    assert out["levels"]["super"]["cm"].shape == (2, 2)
    assert int(out["levels"]["super"]["valid"]) == int((labels != 255).sum())


def test_train_entry_point_runs_a_tiny_three_level_config_on_cpu(tmp_path, capsys):
    d = _cfg_dict(tmp_path, kernels=True, log_every=1)
    d["output"]["metrics_jsonl"] = str(tmp_path / "m.jsonl")
    path = tmp_path / "tiny3.yaml"
    path.write_text(yaml.safe_dump(d))
    assert port_train_main(["--config", str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "has_super=True, n_super=2" in out
    assert "Val super mIoU" in out and "Saved new best model" in out
    assert "| super " in out  # the per-class IoU table's super rows
    assert (tmp_path / "port3" / "step_00000002" / "model.pth").exists()
    rec = yaml.safe_load((tmp_path / "m.jsonl").read_text())
    assert 0.0 <= rec["val_super_miou"] <= 1.0
