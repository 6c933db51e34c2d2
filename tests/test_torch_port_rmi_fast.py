"""The port's ``rmi_precision: fast`` kernel path, streaming RMI path and
config-4 pieces against the JAX package.

Same inputs (made with numpy from a seed) through ``seghiero_tpu`` and
``seghiero_torch`` on the CPU, f32, at small odd sizes: the plain versions
of kernels #6f–#8f inside the port's ``autograd.Function`` against the
Pallas kernels with bf16 views in interpret mode; the row-chunked
streaming path against JAX's; the 3-level composite loss at a non-4×
logits-to-labels ratio; and ResNet-101's parameter layout. The CUDA
kernels are held against the plain versions by
tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from seghiero_torch.config import SegHieroConfig as PortConfig
from seghiero_torch.hierarchy import Hierarchy as PortHierarchy
from seghiero_torch.losses import fast as port_fast
from seghiero_torch.losses import rmi as port_rmi
from seghiero_torch.models.convert import export_reference_checkpoint, load_reference_checkpoint
from seghiero_torch.models.segmenter import build_model as port_build_model
from seghiero_torch.ops import rmi_gram as port_rg
from seghiero_torch.train.__main__ import main as port_train_main
from seghiero_tpu.config import SegHieroConfig as JaxConfig
from seghiero_tpu.hierarchy import Hierarchy as JaxHierarchy
from seghiero_tpu.losses import fast as jax_fast
from seghiero_tpu.losses import rmi as jax_rmi
from seghiero_tpu.models.segmenter import build_model as jax_build_model
from seghiero_tpu.ops.pallas.rmi_gram import rmi_logdet_pallas_cmajor

CLASSES_3L = {
    "super_coarse_to_coarse_map": [[0, 2], [3]],
    "super_coarse_names": {0: "x", 1: "y"},
    "coarse_to_fine_map": [[0, 3], [4, 6], [7], [8]],
    "coarse_names": {0: "a", 1: "b", 2: "c", 3: "d"},
    "fine_names": {i: f"f{i}" for i in range(9)},
}


def _maps(seed, B=2, C=3, H=34, W=27):
    """One-hot maps of random labels, logits, and per-(b, c) cotangents."""
    rng = np.random.default_rng(seed)
    oh = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, H, W))].transpose(0, 3, 1, 2)
    lg = (rng.standard_normal((B, C, H, W)) * 2).astype(np.float32)
    cot = rng.uniform(0.5, 1.5, (B, C)).astype(np.float32)
    return np.ascontiguousarray(oh), lg, cot


def _jax_value_and_grad(half_fn, oh, lg, cot):
    """Value and d logits of Σ cot · half(one-hot, sigmoid(logits) + 1e-6)."""
    def f(x):
        return jnp.sum(half_fn(jnp.asarray(oh), jax.nn.sigmoid(x) + 1e-6) * cot)

    v, g = jax.jit(jax.value_and_grad(f))(jnp.asarray(lg))
    return float(v), np.asarray(g)


def _port_value_and_grad(half_fn, oh, lg, cot):
    x = torch.from_numpy(lg).requires_grad_()
    v = (half_fn(torch.from_numpy(oh), torch.sigmoid(x) + 1e-6) * torch.from_numpy(cot)).sum()
    v.backward()
    return v.item(), x.grad.numpy()


def test_fast_kernel_path_matches_pallas_interpret():
    """``precision="fast"``: the plain versions of #6f–#8f (inside
    ``_HalfLogdet``) against JAX's Pallas kernels with bf16 views in
    interpret mode, at B=2, C=3, 34×27. Both round the maps, W, y and P to
    bf16 at the same points and add exact f32 products; they differ in the
    f32 order of the sums and where that order puts a y on the other side of
    a bf16 rounding boundary: value rtol 1e-5, gradient rtol 1e-3 / atol
    1e-6 — the parity path's tolerances (test_torch_port_rmi.py), far
    tighter than JAX's own fast-vs-parity 2e-2."""
    oh, lg, cot = _maps(11)
    want = _jax_value_and_grad(
        lambda o, p: rmi_logdet_pallas_cmajor(o, p, interpret=True, precision="fast"), oh, lg, cot)
    got = _port_value_and_grad(
        lambda o, p: port_rg.rmi_logdet_kernel_cmajor(o, p, precision="fast"), oh, lg, cot)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3, atol=1e-6)
    # and the fast path is not the parity path: bf16 views move the value
    parity = _port_value_and_grad(port_rg.rmi_logdet_kernel_cmajor, oh, lg, cot)
    assert got[0] != parity[0]
    np.testing.assert_allclose(got[0], parity[0], rtol=2e-2)


def test_fast_plain_versions_round_where_the_tpu_kernel_does():
    """The plain fast versions equal the parity versions on inputs that are
    already bf16 (the maps, W, P) except for #7f's rounded residual y."""
    rng = np.random.default_rng(12)
    la = torch.from_numpy(rng.integers(0, 2, (2, 9, 13)).astype(np.float32))
    pr = torch.from_numpy(rng.random((2, 9, 13)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 9, 9)).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal((2, 9, 18)).astype(np.float32))
    r = port_rg.bf16_round
    assert torch.equal(port_rg.gram18_plain(la, pr, "fast"), port_rg.gram18_plain(r(la), r(pr)))
    assert torch.equal(port_rg.grad_maps_plain(la, pr, p, "fast"),
                       port_rg.grad_maps_plain(r(la), r(pr), r(p)))
    y = r(port_rg._views(r(la)) - r(w).mT @ port_rg._views(r(pr)))
    assert torch.equal(port_rg.residual_gram_plain(la, pr, w, "fast"), y @ y.mT)
    assert not torch.equal(port_rg.residual_gram_plain(la, pr, w, "fast"),
                           port_rg.residual_gram_plain(r(la), r(pr), r(w)))
    with pytest.raises(ValueError, match="precision"):
        port_rg.gram18(la, pr, "bf16")


def test_streaming_matches_jax_streaming():
    """The row-chunked streaming path against JAX's
    ``rmi_logdet_streaming_cmajor`` with 8-row chunks (32 = 4 chunks of
    the 34-row maps' 32 output rows), values and gradients, and against
    the port's materialized op: the same f32 algorithm with its sums
    split over chunks in another order (the tolerances of
    test_torch_port_rmi.py's core test)."""
    oh, lg, cot = _maps(13)
    assert port_rmi._pick_chunk_rows(32, 8) == 8
    want = _jax_value_and_grad(
        lambda o, p: jax_rmi.rmi_logdet_streaming_cmajor(o, p, target_rows=8), oh, lg, cot)
    got = _port_value_and_grad(
        lambda o, p: port_rmi.rmi_logdet_streaming_cmajor(o, p, target_rows=8), oh, lg, cot)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3, atol=1e-6)
    B, C, H, W = lg.shape

    def materialized(o, p):
        def nbhd(x):
            return torch.stack([x[:, :, y : y + H - 2, xx : xx + W - 2] for y in range(3)
                                for xx in range(3)], dim=2).reshape(B, C, 9, -1)

        return port_rmi._rmi_logdet_core(nbhd(o), nbhd(p), 9, False)

    core = _port_value_and_grad(materialized, oh, lg, cot)
    np.testing.assert_allclose(got[0], core[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], core[1], rtol=1e-3, atol=1e-6)


def test_fast_rmi_loss_at_a_non_4x_ratio_matches_jax():
    """The 3-level composite with 17² logits against 67² labels and a 5²
    embedding (config 4's 193 → 769 and 769 → 25 are not integer ratios
    either): the bilinear upsample and the nearest label downsample at
    non-integer ratios, with ``rmi_backend: xla`` (the materialized op on
    both sides), value and gradients, mid-schedule so the triplet term is
    live. Tolerances of test_fast_rmi_hiera_triplet_loss_matches_jax."""
    rng = np.random.default_rng(14)
    jh, ph = JaxHierarchy.from_class_config(CLASSES_3L), PortHierarchy.from_class_config(CLASSES_3L)
    lo = (rng.standard_normal((2, 15, 17, 17)) * 2).astype(np.float32)
    emb = rng.standard_normal((2, 16, 5, 5)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    labels = rng.integers(0, 9, (2, 67, 67)).astype(np.int32)
    labels[:, 5:11, 3:20] = 255
    # classes 1, 2 (upper group) and 8 (lower) where the 67 → 5 nearest
    # downsample reads (rows and columns 0, 13, 26, 40, 53)
    for lbl, (y, x) in zip((1, 2, 8, 5), ((0, 0), (0, 26), (26, 0), (40, 40))):
        labels[:, y, x] = lbl
    step = 30_000
    jloss = jax_fast.FastRMIHieraTripletLoss(jh, rmi_backend="xla", hiera_precision="parity")

    def f(lo_, emb_):
        return jloss(jnp.int32(step), jnp.transpose(emb_, (0, 2, 3, 1)), None,
                     jnp.transpose(lo_, (0, 2, 3, 1)), jnp.asarray(labels))

    v, (g_lo, g_emb) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(jnp.asarray(lo),
                                                                      jnp.asarray(emb))
    ploss = port_fast.FastRMIHieraTripletLoss(ph, rmi_backend="xla", rmi_precision="fast")
    lo_t, emb_t = torch.from_numpy(lo).requires_grad_(), torch.from_numpy(emb).requires_grad_()
    got = ploss(step, emb_t, None, lo_t, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(v), rtol=1e-5)
    np.testing.assert_allclose(lo_t.grad.numpy(), np.asarray(g_lo), rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(emb_t.grad.numpy(), np.asarray(g_emb), rtol=1e-4, atol=1e-7)
    assert np.abs(emb_t.grad.numpy()).max() > 0  # the triplet term is live


def test_resnet101_layout_matches_jax():
    """ResNet-101 (config 4's backbone) with the heads: the checkpoint the
    port's converter makes of JAX's variables — shapes from
    ``jax.eval_shape`` of the init, no compute — loads into the port's
    model with ``strict=True``, and every state-dict entry has JAX's shape."""
    d = {"classes": CLASSES_3L,
         "model": {"depth": 101, "dtype": "float32", "aspp_channels": 32, "c1_channels": 8,
                   "proj_dim": 16}}
    jmodel = jax_build_model(JaxConfig.from_dict(d))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 65, 65, 3)),
                                                train=False))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    ckpt = export_reference_checkpoint(variables, 101)
    model = port_build_model(PortConfig.from_dict(d))
    load_reference_checkpoint(model, ckpt)
    blocks = {}
    for k in ckpt["backbone_state_dict"]:
        if k.startswith("layer"):
            stage, b = k.split(".")[:2]
            blocks[stage] = max(blocks.get(stage, 0), int(b) + 1)
    assert blocks == {"layer1": 3, "layer2": 4, "layer3": 23, "layer4": 3}
    for part, module in (("backbone_state_dict", model.backbone),
                         ("aspp_head_state_dict", model.aspp_head),
                         ("aux_head_state_dict", model.aux_head)):
        mine = module.state_dict()
        assert set(mine) == set(ckpt[part])
        for k, v in ckpt[part].items():
            assert tuple(mine[k].shape) == tuple(v.shape), (part, k)


def test_train_entry_point_runs_config_4_narrowed_on_cpu(tmp_path, capsys):
    """``python -m seghiero_torch.train --device cpu`` on the config-4 YAML
    narrowed to a CPU drive (depth 18, narrow head, 65² images: every stage
    odd, 17² logits upsampled to 65 at a non-integer ratio, RMI maps of 63
    output rows and columns), ``rmi_precision: fast`` through the plain
    kernels: the epoch table with the super level and a checkpoint."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", "example-train-r101-769-hopper.yaml")) as f:
        d = yaml.safe_load(f)
    assert (d["model"]["depth"], d["transform"]["resize"], d["training"]["rmi_precision"]) \
        == (101, [769, 769], "fast")
    d["dataset"]["synthetic_size"] = 4
    d["model"].update(depth=18, dtype="float32", aspp_channels=16, c1_channels=8, proj_dim=8,
                      dilations=[1, 2, 3, 4])
    d["training"].update(num_workers=0, log_every=1)
    d["transform"] = {"resize": [65, 65], "hflip_prob": 0.0}
    d["output"] = {"checkpoint_dir": str(tmp_path), "project_name": "port4"}
    path = tmp_path / "tiny4.yaml"
    path.write_text(yaml.safe_dump(d))
    port_rg.gram18_fast_launches = 0
    assert port_train_main(["--config", str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "has_super=True, n_super=2" in out and "Val super mIoU" in out
    assert (tmp_path / "port4" / "step_00000002" / "model.pth").exists()
    assert port_rg.gram18_fast_launches == 0  # the CPU runs the plain versions
