"""The port's 2-level training losses against the JAX package.

Same inputs (made with numpy from a seed) through ``seghiero_tpu.losses``
and ``seghiero_torch.losses`` on the CPU, f32: values, and gradients with
respect to the logits and the embedding. The port's fused path runs the
plain versions of its kernels (``ops/hiera2_fused.py``); the JAX side runs
its XLA path (the Pallas kernel has no CPU mode outside interpret mode,
which tests/test_torch_port_train_kernels.py covers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from seghiero_torch.hierarchy import Hierarchy as PortHierarchy
from seghiero_torch.losses import fast as port_fast
from seghiero_torch.losses import hiera as port_hiera
from seghiero_torch.losses import tree_triplet as port_tt
from seghiero_torch.ops.resize import downsample_labels_nearest, half_size
from seghiero_tpu.hierarchy import Hierarchy as JaxHierarchy
from seghiero_tpu.losses import fast as jax_fast
from seghiero_tpu.losses import hiera as jax_hiera
from seghiero_tpu.losses import tree_triplet as jax_tt
from seghiero_tpu.ops.resize import downsample_labels_nearest as jax_downsample
from seghiero_tpu.ops.resize import half_size as jax_half_size

CLASSES = {
    "coarse_to_fine_map": [[0, 3], [4, 6], [7], [8]],
    "coarse_names": {0: "a", 1: "b", 2: "c", 3: "d"},
    "fine_names": {i: f"f{i}" for i in range(9)},
}
JH, PH = JaxHierarchy.from_class_config(CLASSES), PortHierarchy.from_class_config(CLASSES)


def _inputs(seed, B=2, h=8, w=8, D=16, saturate=False):
    """Head logits [B, 13, h, w] at 1/4, an L2-normalized embedding
    [B, D, h/4, w/4] at 1/16, labels [B, 4h, 4w] with ignore pixels and
    planted classes where the nearest downsample reads, so the triplet is
    live (classes 1, 2 share coarse bucket 0; 4, 7 lie outside)."""
    rng = np.random.default_rng(seed)
    lo = (rng.standard_normal((B, 13, h, w)) * 2).astype(np.float32)
    if saturate:
        lo = np.where(rng.random(lo.shape) < 0.05, np.sign(lo) * 40.0, lo).astype(np.float32)
    emb = rng.standard_normal((B, D, h // 4, w // 4)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    labels = rng.integers(0, 9, (B, 4 * h, 4 * w)).astype(np.int32)
    labels[:, 3:7, 2:9] = 255
    H = 4 * h
    for lbl, (y, x) in zip((1, 2, 4, 7), ((0, 0), (0, H // 2), (H // 2, 0), (H // 2, H // 2))):
        labels[:, y, x] = lbl
    return lo, emb, labels


def _jax_main(lo, emb, labels, step, selection="auto"):
    """JAX FastHieraTripletLoss (XLA path) on NHWC inputs → (value, d lo, d emb)."""
    loss = jax_fast.FastHieraTripletLoss(JH, use_pallas=False, hiera_precision="parity",
                                        selection=selection)

    def f(lo_, emb_):
        return loss(jnp.int32(step), jnp.transpose(emb_, (0, 2, 3, 1)), None,
                    jnp.transpose(lo_, (0, 2, 3, 1)), jnp.asarray(labels))

    v, (g_lo, g_emb) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(jnp.asarray(lo),
                                                                      jnp.asarray(emb))
    return float(v), np.asarray(g_lo), np.asarray(g_emb)


def _port_main(lo, emb, labels, step, use_kernel, selection="auto"):
    loss = port_fast.FastHieraTripletLoss(PH, use_kernel=use_kernel, selection=selection)
    lo_t = torch.from_numpy(lo).requires_grad_()
    emb_t = torch.from_numpy(emb).requires_grad_()
    v = loss(step, emb_t, None, lo_t, torch.from_numpy(labels))
    v.backward()
    return float(v), lo_t.grad.numpy(), emb_t.grad.numpy()


@pytest.mark.parametrize("use_kernel", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("saturate", [False, True], ids=["plain", "saturated"])
def test_fast_hiera_triplet_loss_matches_jax(use_kernel, saturate):
    lo, emb, labels = _inputs(3, saturate=saturate)
    step = 1234  # the triplet ramp is non-zero here
    want = _jax_main(lo, emb, labels, step)
    got = _port_main(lo, emb, labels, step, use_kernel)
    # f32 sums over 2·32·32 pixels in other orders; torch's and XLA's
    # bilinear resizes round differently from the fused phase blend
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-7)
    assert np.abs(got[2]).max() > 0  # the triplet term is live


def test_all_ignored_batch_is_finite_and_matches_jax():
    lo, emb, labels = _inputs(4)
    labels[:] = 255
    want = _jax_main(lo, emb, labels, 10)
    for use_kernel in (False, True):
        got = _port_main(lo, emb, labels, 10, use_kernel)
        assert np.isfinite(got[0]) and np.all(np.isfinite(got[1]))
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[1], want[1], rtol=2e-4, atol=1e-7)


def test_fused_loss_on_the_cpu_takes_the_unfused_path_for_other_ratios():
    """Labels 8x the logits: with ``use_kernel`` the CPU takes the unfused
    path, as JAX's ``fused_hiera2_available`` gate does (on the card it
    raises: tests/test_torch_port_cuda.py)."""
    lo, emb, labels = _inputs(5)
    labels = np.repeat(np.repeat(labels, 2, 1), 2, 2)
    fused, unfused = (_port_main(lo, emb, labels, 10, k) for k in (True, False))
    for a, b in zip(fused, unfused):
        np.testing.assert_array_equal(a, b)


def test_aux_ce_matches_jax():
    rng = np.random.default_rng(6)
    aux = rng.standard_normal((2, 9, 4, 4)).astype(np.float32) * 2
    labels = rng.integers(0, 9, (2, 64, 64)).astype(np.int32)
    labels[:, :10] = 255

    def f(a):
        return jax_fast.aux_ce_fast(jnp.transpose(a, (0, 2, 3, 1)), jnp.asarray(labels))

    v, g = jax.jit(jax.value_and_grad(f))(jnp.asarray(aux))
    a_t = torch.from_numpy(aux).requires_grad_()
    got = port_fast.aux_ce_fast(a_t, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(float(got), float(v), rtol=1e-5)
    np.testing.assert_allclose(a_t.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-8)
    # an all-ignored batch divides by max(n_valid, 1): zero, not NaN
    assert float(port_fast.aux_ce_fast(a_t, torch.full_like(torch.from_numpy(labels), 255))) == 0


@pytest.mark.parametrize("selection", ["mask", "sorted"])
def test_range_triplet_matches_jax(selection):
    """Values, class counts and embedding gradients of both selections; the
    selected pixels include ignore-255 pixels among the negatives."""
    rng = np.random.default_rng(8)
    emb = rng.standard_normal((2, 6, 10, 8)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    labels = rng.integers(0, 9, (2, 40, 32)).astype(np.int32)
    labels[:, ::3, ::2] = 255
    labels[:, :, :4] = 4  # unequal class sizes: some below k, some above

    def f(e):
        return jax_tt.tree_triplet_loss_range(e, jnp.asarray(labels), JH, max_triplet=20,
                                              selection=selection)

    (v, c), g = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(emb))
    e_t = torch.from_numpy(emb).requires_grad_()
    vt, ct = port_tt.tree_triplet_loss_range(e_t, torch.from_numpy(labels), PH,
                                             max_triplet=20, selection=selection)
    vt.backward()
    assert int(ct) == int(c) > 0
    np.testing.assert_allclose(float(vt), float(v), rtol=1e-5)
    np.testing.assert_allclose(e_t.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-7)


def test_triplet_selections_pick_the_same_pixels():
    rng = np.random.default_rng(9)
    emb = torch.from_numpy(rng.standard_normal((1, 12, 12, 4)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 9, (1, 48, 48)).astype(np.int32))
    a = port_tt.tree_triplet_loss_range(emb, labels, PH, max_triplet=30, selection="mask")
    b = port_tt.tree_triplet_loss_range(emb, labels, PH, max_triplet=30, selection="sorted")
    assert int(a[1]) == int(b[1]) and float(a[0]) == float(b[0])


# ADE20K's 150 classes in 15 coarse groups of 10 (the Swin-L cell's tree)
ADE = {
    "coarse_to_fine_map": [[10 * g, 10 * g + 9] for g in range(15)],
    "coarse_names": {g: f"g{g}" for g in range(15)},
    "fine_names": {i: f"c{i}" for i in range(150)},
}


@pytest.mark.parametrize("selection", ["mask", "sorted"])
@pytest.mark.parametrize("variant", ["range", "groups"])
def test_triplet_padded_lanes_go_to_spread_rows(variant, selection, monkeypatch):
    """At Swin-L's shape (embeddings [2, 20, 20, 256], 150 classes in 15
    groups of 10, a few classes present): the lanes past a class's
    ``min_size`` are sent to spread rows, at most ``⌈C·k/n⌉`` to a row,
    and are over 80 % of the lanes; the lanes below it keep their pixels;
    the loss, the class count and the embedding gradient equal those of the
    selections' own indices, bit for bit."""
    h = PortHierarchy.from_class_config(ADE)
    rng = np.random.default_rng(23)
    emb = rng.standard_normal((2, 20, 20, 256)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    labels = np.zeros((2, 160, 160), np.int32)
    for b in range(2):
        for _ in range(8):
            (y, x), (hh, ww) = rng.integers(0, 120, 2), rng.integers(16, 80, 2)
            labels[b, y:y + hh, x:x + ww] = rng.integers(1, 150)
    labels[rng.random(labels.shape) < 0.02] = 255
    lbl = torch.from_numpy(labels)

    def run():
        e = torch.from_numpy(emb).requires_grad_()
        if variant == "range":
            loss, count = port_tt.tree_triplet_loss_range(e, lbl, h, selection=selection)
        else:
            upper, lower = h.split_upper_lower()
            loss, count = port_tt.tree_triplet_loss_groups(e, lbl, upper, lower, 150,
                                                           selection=selection)
        loss.backward()
        return loss.detach(), int(count), e.grad

    gathers = []
    spread = port_tt._spread_padding

    def recorded(idx, lane_valid, n):
        out = spread(idx, lane_valid, n)
        gathers.append((idx, lane_valid, out))
        return out

    monkeypatch.setattr(port_tt, "_spread_padding", recorded)
    loss, count, grad = run()
    monkeypatch.setattr(port_tt, "_spread_padding", lambda idx, lane_valid, n: idx)
    loss0, count0, grad0 = run()
    assert count == count0 > 0
    assert torch.equal(loss, loss0) and torch.equal(grad, grad0)

    n = 2 * 20 * 20
    assert len(gathers) == 3
    C, k = gathers[0][0].shape
    cap = -(-C * k // n)
    for idx, lane_valid, out in gathers:
        padded = ~lane_valid
        assert torch.equal(out[lane_valid], idx[lane_valid])
        assert padded.float().mean() > 0.8
        assert int(torch.bincount(out[padded], minlength=n).max()) <= cap
    if selection == "sorted":  # its selections pile the padded lanes on row n - 1
        assert max(int(torch.bincount(idx[~lv], minlength=n)[n - 1])
                   for idx, lv, _ in gathers) > 100 * cap


def test_targets_schedule_and_label_downsampling_match_jax():
    rng = np.random.default_rng(10)
    labels = rng.integers(0, 9, (2, 21, 17)).astype(np.int32)
    labels[:, :3] = 255
    tf_j, tc_j = jax_hiera.prepare_targets_two_level(jnp.asarray(labels), JH)
    tf_t, tc_t = port_hiera.prepare_targets_two_level(torch.from_numpy(labels), PH)
    np.testing.assert_array_equal(tc_t.numpy(), np.asarray(tc_j))
    assert tc_t.dtype == torch.int32 and np.array_equal(tf_t.numpy(), np.asarray(tf_j))
    np.testing.assert_array_equal(
        downsample_labels_nearest(torch.from_numpy(labels), (5, 4)).numpy(),
        np.asarray(jax_downsample(jnp.asarray(labels), (5, 4))))
    for hw in ((21, 17), (64, 64), (1, 3)):
        assert half_size(hw) == tuple(jax_half_size(hw))
    for step in (0, 1, 39_999, 79_999, 80_000, 123_456):
        assert float(port_tt.triplet_schedule_factor(step, 80_000)) == float(
            jax_tt.triplet_schedule_factor(jnp.int32(step), 80_000))


def test_log_sig_eps_forms_match_jax():
    x = np.concatenate([np.linspace(-60, 60, 241), [-1e-3, 0.0, 1e-3]]).astype(np.float32)
    for ours, theirs in ((port_hiera._log_sig_eps, jax_hiera._log_sig_eps),
                         (port_hiera._log_one_minus_sig_eps, jax_hiera._log_one_minus_sig_eps)):
        np.testing.assert_allclose(ours(torch.from_numpy(x)).numpy(),
                                   np.asarray(theirs(jnp.asarray(x), 1e-8)), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("option", ["hiera_variant", "ohem"])
def test_unported_loss_options_raise(option):
    kw = {"hiera_variant": "focal"} if option == "hiera_variant" else {"ohem": (0.7, 100)}
    with pytest.raises(NotImplementedError, match="not yet ported"):
        port_fast.FastHieraTripletLoss(PH, **kw)


def _many_classes(port: bool, scattered: bool):
    """150 fine classes in 15 coarse groups: the ADE20K-scale hierarchy of
    configs/example-many-classes.yaml (groups of 10 contiguous ids), or
    the same sizes with fine class f in group f mod 15 (no group
    contiguous: ``fine_to_coarse`` not sorted)."""
    H = PortHierarchy if port else JaxHierarchy
    if not scattered:
        return H.from_class_config({
            "coarse_to_fine_map": [[10 * g, 10 * g + 9] for g in range(15)],
            "fine_names": {i: f"c{i}" for i in range(150)}})
    f2c = np.arange(150, dtype=np.int32) % 15
    return H(n_fine=150, n_coarse=15, n_super=0, fine_to_coarse=f2c,
             fine_by_coarse=tuple(tuple(range(g, 150, 15)) for g in range(15)),
             coarse_ranges=None)


@pytest.mark.parametrize("scattered", [False, True], ids=["ade150", "scattered"])
def test_fused_loss_sums_at_150_classes_match_jax_unfused(scattered):
    """The port's ``fused_hiera2_loss_sums`` (the plain versions of kernels
    #4 / #5 on the CPU) at 150 + 15 channels, in the loss assembly of
    ``FastHieraTripletLoss``, against JAX's unfused C-major path at parity
    precision (``_resize_cmajor`` + ``hiera_bce_two_level_cmajor`` + two
    ``_ce_cmajor``: the function tests/test_pallas_fused.py holds the
    Pallas kernel to). Random logits (no ties), a tenth of the pixels
    ignored; value within 1e-5 relative, d lo within rtol 2e-4, atol 1e-7
    (the 13-class tolerances above)."""
    from seghiero_torch.ops.hiera2_fused import fused_hiera2_loss_sums

    jh, ph = _many_classes(False, scattered), _many_classes(True, scattered)
    rng = np.random.default_rng(12)
    lo = (rng.standard_normal((1, 165, 8, 8)) * 3).astype(np.float32)
    labels = rng.integers(0, 150, (1, 32, 32)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.1] = 255

    def f(x):
        tf, tc = jax_hiera.prepare_targets_two_level(jnp.asarray(labels), jh)
        lf = jax_fast._resize_cmajor(x, (32, 32))
        return (jax_fast.hiera_bce_two_level_cmajor(lf, tf, tc, jh)
                + jax_fast._ce_cmajor(lf[:, :150], tf, 255)
                + jax_fast._ce_cmajor(lf[:, 150:], tc, 255))

    # LLVM's backend optimizations only lengthen this compile
    v, g = jax.jit(jax.value_and_grad(f), compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})(jnp.asarray(lo))
    tf, tc = port_hiera.prepare_targets_two_level(torch.from_numpy(labels), ph)
    lo_t = torch.from_numpy(lo).requires_grad_()
    s_f, s_c, nvf, nvc, ce_f, ce_c = fused_hiera2_loss_sums(lo_t, tf.to(torch.int32),
                                                            tc.to(torch.int32), ph)
    total = labels.size
    got = (5.0 * (s_f / (torch.clamp(nvf, min=1.0) * 150)
                  + s_c / (torch.clamp(nvc, min=1.0) * 15))
           + ce_f / total + ce_c / total)
    got.backward()
    np.testing.assert_allclose(got.item(), float(v), rtol=1e-5)
    np.testing.assert_allclose(lo_t.grad.numpy(), np.asarray(g), rtol=2e-4, atol=1e-7)
