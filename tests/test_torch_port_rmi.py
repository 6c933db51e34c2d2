"""The port's 3-level losses and RMI kernels against the JAX package.

Same inputs (made with numpy from a seed) through ``seghiero_tpu`` and
``seghiero_torch`` on the CPU, f32: the 3-level targets, hierarchy BCE and
group triplet; the materialized RMI core; the kernel path (the plain
versions of kernels #6–#8 inside the port's ``autograd.Function``) against
the Pallas kernels in interpret mode; the backend and precision knobs; and
the whole ``FastRMIHieraTripletLoss``. The CUDA kernels are held against
the plain versions by tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import itertools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from seghiero_torch.hierarchy import Hierarchy as PortHierarchy
from seghiero_torch.losses import fast as port_fast
from seghiero_torch.losses import hiera as port_hiera
from seghiero_torch.losses import rmi as port_rmi
from seghiero_torch.losses import tree_triplet as port_tt
from seghiero_torch.ops import rmi_gram as port_rg
from seghiero_tpu.hierarchy import Hierarchy as JaxHierarchy
from seghiero_tpu.losses import fast as jax_fast
from seghiero_tpu.losses import hiera as jax_hiera
from seghiero_tpu.losses import rmi as jax_rmi
from seghiero_tpu.losses import tree_triplet as jax_tt
from seghiero_tpu.ops.pallas.rmi_gram import rmi_logdet_pallas_cmajor

CLASSES_3L = {
    "super_coarse_to_coarse_map": [[0, 2], [3]],
    "super_coarse_names": {0: "x", 1: "y"},
    "coarse_to_fine_map": [[0, 3], [4, 6], [7], [8]],
    "coarse_names": {0: "a", 1: "b", 2: "c", 3: "d"},
    "fine_names": {i: f"f{i}" for i in range(9)},
}
JH, PH = JaxHierarchy.from_class_config(CLASSES_3L), PortHierarchy.from_class_config(CLASSES_3L)
UPPER, LOWER = PH.split_upper_lower()  # (1..7), (8,): super bucket 0 vs 1


def _labels(rng, B, H, W):
    """Fine labels with an ignore block and planted classes 1, 2 (upper
    group) and 8 (lower) where the 1/16 nearest downsample reads."""
    labels = rng.integers(0, 9, (B, H, W)).astype(np.int32)
    labels[:, 3:7, 2:9] = 255
    for lbl, (y, x) in zip((1, 2, 8, 5), ((0, 0), (0, W // 2), (H // 2, 0), (H // 2, W // 2))):
        labels[:, y, x] = lbl
    return labels


def _rmi_maps(seed, B=2, C=3, H=18, W=20):
    """One-hot maps of random labels and sigmoid(logits) + 1e-6, [B, C, H, W]."""
    rng = np.random.default_rng(seed)
    oh = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, H, W))].transpose(0, 3, 1, 2)
    lg = rng.standard_normal((B, C, H, W)).astype(np.float32) * 2
    return np.ascontiguousarray(oh), lg


def test_three_level_targets_and_hiera_bce_match_jax():
    rng = np.random.default_rng(0)
    labels = _labels(rng, 2, 24, 20)
    jt = jax_hiera.prepare_targets_three_level(jnp.asarray(labels), JH)
    pt = port_hiera.prepare_targets_three_level(torch.from_numpy(labels), PH)
    for a, b in zip(pt, jt):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    lf = (rng.standard_normal((2, 15, 24, 20)) * 3).astype(np.float32)
    lf = np.where(rng.random(lf.shape) < 0.05, np.sign(lf) * 40.0, lf).astype(np.float32)
    v, g = jax.jit(jax.value_and_grad(
        lambda x: jax_fast.hiera_bce_three_level_cmajor(x, *jt, JH)))(jnp.asarray(lf))
    lf_t = torch.from_numpy(lf).requires_grad_()
    got = port_fast.hiera_bce_three_level_cmajor(lf_t, *pt, PH)
    got.backward()
    # f32 sums over 960 pixels in another order; the same logit-space forms
    np.testing.assert_allclose(got.item(), float(v), rtol=1e-5)
    np.testing.assert_allclose(lf_t.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-8)
    oh_j, v_j = jax_hiera._one_hot_valid(jnp.asarray(labels), 9, 255)
    oh_t, v_t = port_hiera._one_hot_valid(torch.from_numpy(labels), 9, 255)
    np.testing.assert_array_equal(oh_t.numpy(), np.asarray(oh_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(
        port_hiera._one_hot_valid(torch.from_numpy(labels), 9, 255, dim=1)[0].numpy(),
        np.asarray(oh_j).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("selection", ["mask", "sorted"])
def test_group_triplet_matches_jax(selection):
    """Values, class counts and embedding gradients of both selections, with
    ignore pixels and unequal class sizes (some below k, some above)."""
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((2, 6, 10, 8)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    labels = rng.integers(0, 9, (2, 40, 32)).astype(np.int32)
    labels[:, ::3, ::2] = 255
    labels[:, :, :4] = 8

    def f(e):
        return jax_tt.tree_triplet_loss_groups(e, jnp.asarray(labels), UPPER, LOWER, 9,
                                               max_triplet=20, selection=selection)

    (v, c), g = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(emb))
    e_t = torch.from_numpy(emb).requires_grad_()
    vt, ct = port_tt.tree_triplet_loss_groups(e_t, torch.from_numpy(labels), UPPER, LOWER, 9,
                                              max_triplet=20, selection=selection)
    vt.backward()
    assert int(ct) == int(c) > 0
    np.testing.assert_allclose(vt.item(), float(v), rtol=1e-5)
    np.testing.assert_allclose(e_t.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-7)


def test_group_triplet_edge_cases():
    rng = np.random.default_rng(2)
    emb = torch.from_numpy(rng.standard_normal((1, 12, 12, 4)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 9, (1, 48, 48)).astype(np.int32))
    a = port_tt.tree_triplet_loss_groups(emb, labels, UPPER, LOWER, 9, max_triplet=30,
                                         selection="mask")
    b = port_tt.tree_triplet_loss_groups(emb, labels, UPPER, LOWER, 9, max_triplet=30,
                                         selection="sorted")
    assert int(a[1]) == int(b[1]) > 0 and float(a[0]) == float(b[0])
    with pytest.raises(ValueError, match=r"out of range \[0, 9\): \[9\]"):
        port_tt.tree_triplet_loss_groups(emb, labels, (1, 9), (8,), 9)
    v, c = port_tt.tree_triplet_loss_groups(emb, labels, (), (), 9)  # empty groups
    assert float(v) == 0.0 and int(c) == 0


def _jax_core(oh, lg, cot):
    """JAX's materialized core: (value of Σ cot·half, d logits)."""
    B, C, H, W = lg.shape
    nh, nw = H - 2, W - 2

    def nbhd(x):
        return jnp.stack([x[:, :, y : y + nh, xx : xx + nw] for y in range(3) for xx in range(3)],
                         axis=2).reshape(B, C, 9, nh * nw)

    def f(x):
        half = jax_rmi._rmi_logdet_core(nbhd(jnp.asarray(oh)), nbhd(jax.nn.sigmoid(x) + 1e-6),
                                        9, False)
        return jnp.sum(half * cot)

    v, g = jax.jit(jax.value_and_grad(f))(jnp.asarray(lg))
    return float(v), np.asarray(g)


def _port_half(oh, lg, cot, half_fn):
    lg_t = torch.from_numpy(lg).requires_grad_()
    v = (half_fn(torch.from_numpy(oh), torch.sigmoid(lg_t) + 1e-6) * torch.from_numpy(cot)).sum()
    v.backward()
    return v.item(), lg_t.grad.numpy()


def _port_core_half(oh, pr):
    B, C, H, W = pr.shape

    def nbhd(x):
        return torch.stack([x[:, :, y : y + H - 2, xx : xx + W - 2] for y in range(3)
                            for xx in range(3)], dim=2).reshape(B, C, 9, -1)

    return port_rmi._rmi_logdet_core(nbhd(oh), nbhd(pr), 9, False)


def test_rmi_core_matches_jax():
    """The materialized core, value and gradient, against JAX's: the same
    f32 algorithm; the products and the 9×9 solve and Cholesky round in
    another order, and the logdet's conditioning amplifies that."""
    oh, lg = _rmi_maps(3)
    cot = np.random.default_rng(4).uniform(0.5, 1.5, (2, 3)).astype(np.float32)
    want = _jax_core(oh, lg, cot)
    got = _port_half(oh, lg, cot, _port_core_half)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3, atol=1e-6)


def test_rmi_kernel_path_matches_pallas_interpret():
    """The port's kernel path (plain kernels inside ``_HalfLogdet``) against
    JAX's Pallas kernels in interpret mode and against JAX's materialized
    core, at B=2, C=3, 18×20 (the tolerances of JAX's own kernel-vs-core
    test, tests/test_rmi_gram_pallas.py: value rtol 2e-4, gradient rtol
    5e-3 / atol 2e-5). Against the Pallas kernels — the same algorithm,
    sums in another order — the tolerance is tighter."""
    oh, lg = _rmi_maps(5)
    cot = np.random.default_rng(6).uniform(0.5, 1.5, (2, 3)).astype(np.float32)

    def f(x):
        half = rmi_logdet_pallas_cmajor(jnp.asarray(oh), jax.nn.sigmoid(x) + 1e-6,
                                        interpret=True)
        return jnp.sum(half * cot)

    v_p, g_p = jax.jit(jax.value_and_grad(f))(jnp.asarray(lg))
    got = _port_half(oh, lg, cot, port_rg.rmi_logdet_kernel_cmajor)
    np.testing.assert_allclose(got[0], float(v_p), rtol=1e-5)
    np.testing.assert_allclose(got[1], np.asarray(g_p), rtol=1e-3, atol=1e-6)
    core = _jax_core(oh, lg, cot)
    np.testing.assert_allclose(got[0], core[0], rtol=2e-4)
    np.testing.assert_allclose(got[1], core[1], rtol=5e-3, atol=2e-5)


def test_rmi_plain_kernels_are_the_sums_they_name():
    """The plain versions against float64 numpy sums (Gram entries) and
    autograd (the overlap-add is the VJP of the views), at a ragged shape."""
    rng = np.random.default_rng(7)
    la = rng.integers(0, 2, (3, 7, 11)).astype(np.float32)
    pr = rng.random((3, 7, 11)).astype(np.float32)
    w = rng.standard_normal((3, 9, 9)).astype(np.float32)
    p = rng.standard_normal((3, 9, 18)).astype(np.float32)
    z = np.concatenate([np.stack([m[:, dy : dy + 5, dx : dx + 9].reshape(3, -1)
                                  for dy in range(3) for dx in range(3)], 1)
                        for m in (la.astype(np.float64), pr.astype(np.float64))], 1)
    t = {k: torch.from_numpy(v) for k, v in (("la", la), ("pr", pr), ("w", w), ("p", p))}
    np.testing.assert_allclose(port_rg.gram18_plain(t["la"], t["pr"]).numpy(),
                               z @ z.transpose(0, 2, 1), rtol=1e-6, atol=1e-5)
    y = z[:, :9] - np.swapaxes(w, 1, 2).astype(np.float64) @ z[:, 9:]
    np.testing.assert_allclose(port_rg.residual_gram_plain(t["la"], t["pr"], t["w"]).numpy(),
                               y @ y.transpose(0, 2, 1), rtol=1e-5, atol=1e-4)
    pr_req = t["pr"].clone().requires_grad_()
    u = (t["p"] @ torch.cat([port_rg._views(t["la"]), port_rg._views(pr_req)], 1)).detach()
    # d/dpr Σ u_k·(view k of pr) overlap-adds each u_k through its view
    (u[:, :9] * port_rg._views(pr_req)).sum().backward()
    # 9 terms per pixel added in another order than autograd's
    torch.testing.assert_close(port_rg.grad_maps_plain(t["la"], t["pr"], t["p"]), pr_req.grad,
                               rtol=1e-5, atol=1e-5)


def _fold_taps(p: torch.Tensor) -> torch.Tensor:
    """``T [BC, 2, 5, 5]``: ``T[m][2+ey−dy][2+ex−dx] = Σ_k P[k, 9m+3ey+ex]`` over
    ``k = 3dy + dx``, the sums kernel #8 folds once per map."""
    t = torch.zeros((p.shape[0], 2, 5, 5), dtype=p.dtype)
    for dy, dx, m, ey, ex in itertools.product(range(3), range(3), range(2), range(3), range(3)):
        t[:, m, 2 + ey - dy, 2 + ex - dx] += p[:, 3 * dy + dx, 9 * m + 3 * ey + ex]
    return t


@pytest.mark.parametrize("shape", [(3, 18, 20), (2, 37, 131), (1, 5, 5), (1, 4, 7)])
def test_grad_maps_is_a_folded_correlation_inside_the_frame(shape):
    """The identities kernel #8 and the smoke's yardstick rest on. Inside the
    2-pixel frame (rows and columns 2 … H−3, W−3) every view is valid, and
    ``grad_maps_plain`` is a 5×5 correlation of each map with taps folded
    from P: in f64 within 1e-12 of Σ|P|·|z|, and in f32 on the bf16-rounded
    maps and P (``precision="fast"``, taps folded from the rounded P) within
    1e-5 of it, the kernels' tolerance. On the frame it is not (so the
    kernel keeps the general form there): every frame pixel differs. The
    two-call cuDNN composition (``conv2d`` with P as 9 3×3 filters per map
    pair, ``conv_transpose2d`` with the 9 shift one-hots) equals it
    everywhere. [1, 5, 5] has one interior pixel, [1, 4, 7] none."""
    BC, H, W = shape
    rng = np.random.default_rng(sum(shape))
    la = torch.from_numpy((rng.random(shape) < 0.3).astype(np.float32))
    pr = torch.from_numpy(rng.random(shape).astype(np.float32) + 1e-6)
    p = torch.from_numpy(rng.standard_normal((BC, 9, 18)).astype(np.float32))
    la64, pr64, p64 = la.double(), pr.double(), p.double()

    def corr(la, pr, p):
        x = torch.stack([la, pr], dim=1).reshape(1, 2 * BC, H, W)
        return F.conv2d(x, _fold_taps(p), groups=BC, padding=2)[0]

    inner = torch.zeros(shape, dtype=torch.bool)
    inner[:, 2:H - 2, 2:W - 2] = True
    want = port_rg.grad_maps_plain(la64, pr64, p64)
    mag = port_rg.grad_maps_plain(la64, pr64, p64.abs())
    diff = (corr(la64, pr64, p64) - want).abs()
    assert (diff[inner] <= 1e-12 * mag[inner]).all()
    assert (diff[~inner] > 1e-6 * mag[~inner]).all()

    r = port_rg.bf16_round
    want_f = port_rg.grad_maps_plain(la64, pr64, p64, "fast")
    mag_f = port_rg.grad_maps_plain(la64, pr64, p64.abs(), "fast")
    got_f = corr(r(la), r(pr), r(p))
    assert got_f.dtype == torch.float32
    assert ((got_f.double() - want_f).abs()[inner] <= 1e-5 * mag_f[inner]).all()

    x = torch.stack([la64, pr64], dim=1).reshape(1, 2 * BC, H, W)
    shifts = torch.eye(9, dtype=torch.float64).reshape(9, 1, 3, 3).repeat(BC, 1, 1, 1)
    two = F.conv_transpose2d(F.conv2d(x, p64.reshape(9 * BC, 2, 3, 3), groups=BC), shifts,
                             groups=BC)[0]
    assert ((two - want).abs() <= 1e-12 * mag).all()


def _entry_lag(i: int, j: int):
    """Entry (i, j) of G18 as kernel #6 sums it: its anchor view a (0 … 17),
    its lag (ly, lx) from the anchor to the other view, and that lag's index
    among the 51 (csrc/rmi_gram.cu ``entry_lag``): la·la and pr·pr at the 13
    lags of the half-plane {ly > 0} ∪ {ly = 0, lx ≥ 0}, anchored at the
    earlier view; la·pr at all 25, anchored at la."""
    i, j = max(i, j), min(i, j)
    (mi, ki), (mj, kj) = divmod(i, 9), divmod(j, 9)
    ly, lx = ki // 3 - kj // 3, ki % 3 - kj % 3
    if mi != mj:
        return kj, ly, lx, 26 + (ly + 2) * 5 + lx + 2
    a = 9 * mi + kj
    if ly < 0 or (ly == 0 and lx < 0):
        a, ly, lx = 9 * mi + ki, -ly, -lx
    return a, ly, lx, 13 * mi + (lx if ly == 0 else 3 + (ly - 1) * 5 + lx + 2)


def _gram18_as_lag_sums(la: torch.Tensor, pr: torch.Tensor):
    """G18 ``[BC, 18, 18]`` as kernel #6 forms it, in the maps' dtype: the
    51 lag sums ``Σ_x map_a(x)·map_b(x + l)`` over the core anchors x (input
    rows and columns 2 … H−3, W−3, where every view's x − s_a is a valid
    output pixel), and per entry the general form over the frame anchors
    (those with x − s_a valid). Returns (G18, the core sums alone per
    entry)."""
    BC, H, W = pr.shape
    nh, nw = H - 2, W - 2
    maps = (la, pr)
    padded = [F.pad(m, (2, 2, 2, 2)) for m in maps]
    rows = torch.arange(H)[:, None]
    cols = torch.arange(W)[None, :]
    core = (rows >= 2) & (rows < H - 2) & (cols >= 2) & (cols < W - 2)
    lag_sums = {}
    g18 = torch.zeros((BC, 18, 18), dtype=pr.dtype)
    core_only = torch.zeros_like(g18)
    for i, j in itertools.product(range(18), range(18)):
        a, ly, lx, lag = _entry_lag(i, j)
        mb = int(max(i, j) >= 9)  # the partner: la only in la·la entries
        ma, (dy, dx) = a // 9, divmod(a % 9, 3)
        prod = maps[ma] * padded[mb][:, 2 + ly : 2 + ly + H, 2 + lx : 2 + lx + W]
        if lag not in lag_sums:
            lag_sums[lag] = (prod * core).sum((1, 2))
        valid = ((rows - dy >= 0) & (rows - dy < nh) & (cols - dx >= 0) & (cols - dx < nw))
        g18[:, i, j] = lag_sums[lag] + (prod * (valid & ~core)).sum((1, 2))
        core_only[:, i, j] = lag_sums[lag]
    assert len(lag_sums) == 51
    return g18, core_only


@pytest.mark.parametrize("shape", [(3, 18, 20), (2, 37, 131), (1, 5, 5), (1, 4, 7), (1, 3, 3)])
def test_gram18_is_lag_correlations_on_the_core(shape):
    """The identity kernel #6 rests on: every G18 entry is a lag sum anchored
    at one of its views, so on the core (input rows and columns 2 … H−3,
    W−3) the 171 entries share 51 lag sums (13 la·la, 13 pr·pr, 25 la·pr),
    and on the 2-pixel frame each entry keeps the general form. In f64 it
    equals ``gram18_plain`` within 1e-12 of Σ|z_i·z_j|; in f32 on the
    bf16-rounded maps it equals the fast plain version within 1e-5, the
    kernel's tolerance. The core sums alone are not G18: every pr·pr entry
    (pr > 0 everywhere) has frame anchors. [1, 5, 5] has one core pixel,
    [1, 4, 7] and [1, 3, 3] none."""
    rng = np.random.default_rng(sum(shape))
    la = torch.from_numpy((rng.random(shape) < 0.3).astype(np.float32))
    pr = torch.from_numpy(rng.random(shape).astype(np.float32) + 1e-6)
    la64, pr64 = la.double(), pr.double()
    mag = port_rg.gram18_plain(la64, pr64)  # la, pr ≥ 0: Σ|z_i·z_j| is G18
    got, core_only = _gram18_as_lag_sums(la64, pr64)
    assert ((got - mag).abs() <= 1e-12 * mag).all()
    assert ((core_only - mag).abs()[:, 9:, 9:] > 1e-6 * mag[:, 9:, 9:]).all()

    r = port_rg.bf16_round
    want_f = port_rg.gram18_plain(la64, pr64, "fast")
    got_f, _ = _gram18_as_lag_sums(r(la), r(pr))
    assert got_f.dtype == torch.float32
    assert ((got_f.double() - want_f).abs() <= 1e-5 * want_f).all()


def test_rmi_knobs():
    oh = torch.zeros((2, 3, 16, 16))
    pr = torch.full((2, 3, 16, 16), 0.5)
    with pytest.raises(ValueError, match="rmi_radius == 3"):
        port_rmi.rmi_lower_bound_cmajor(oh, pr, radius=5, backend="pallas")
    with pytest.raises(ValueError, match="f32-only"):
        port_rmi.rmi_lower_bound_cmajor(oh, pr, use_float64=True, backend="pallas")
    with pytest.raises(ValueError, match="precision"):
        port_rmi.rmi_lower_bound_cmajor(oh, pr, precision="bf16")
    # rmi_precision: fast reaches the kernels only (their plain versions on
    # the CPU); the materialized op ignores it, as JAX's does
    pr_r = pr + 0.1 * torch.rand(pr.shape, generator=torch.Generator().manual_seed(0))
    oh_r = (torch.rand(pr.shape, generator=torch.Generator().manual_seed(1)) < 0.5).float()
    fast, parity = (port_rmi.rmi_lower_bound_cmajor(oh_r, pr_r, backend="pallas", precision=p)
                    for p in ("fast", "parity"))
    assert torch.isfinite(fast) and float(fast) != float(parity)
    assert float(port_rmi.rmi_lower_bound_cmajor(oh_r, pr_r, backend="xla", precision="fast")) \
        == float(port_rmi.rmi_lower_bound_cmajor(oh_r, pr_r, backend="xla"))
    # streaming on: the row-chunked path, the materialized op's value within
    # f32 order (tests/test_torch_port_rmi_fast.py holds it against JAX)
    streamed = port_rmi.rmi_lower_bound_cmajor(oh_r, pr_r, streaming="on")
    torch.testing.assert_close(streamed, port_rmi.rmi_lower_bound_cmajor(oh_r, pr_r),
                               rtol=1e-5, atol=0)
    # the route, JAX's decision, without computing at these sizes: 2.6 GB of
    # views stream under auto; rows that split into chunks of fewer than 8
    # (1097 output rows: a prime) take the materialized op even when asked
    cpu = torch.device("cpu")
    route = port_rmi.rmi_route
    assert route((4, 15, 1100, 1100), 3, False, "auto", "auto", cpu) == "streaming"
    assert route((4, 15, 1100, 1100), 3, False, "off", "auto", cpu) == "materialized"
    assert route((2, 15, 769, 769), 3, False, "auto", "xla", cpu) == "materialized"  # 0.59 GB
    assert route((2, 15, 769, 769), 3, False, "on", "xla", cpu) == "streaming"
    assert route((1, 3, 1099, 40), 3, False, "on", "xla", cpu) == "materialized"
    assert route((4, 15, 1100, 1100), 3, False, "auto", "pallas", cpu) == "kernels"
    assert route((4, 15, 1100, 1100), 3, False, "auto", "auto", torch.device("cuda")) == "kernels"
    # radius 3 under pallas on the CPU: the plain kernels, equal to auto
    # (which on the CPU takes the materialized op) within the two paths'
    # tolerance; radius 5 and f64 take the op under auto
    a = port_rmi.rmi_lower_bound_cmajor(oh, pr + 0.1 * torch.rand(pr.shape), backend="pallas")
    assert torch.isfinite(a)
    port_rg.gram18_launches = port_rg.residual_launches = port_rg.grad_launches = 0
    for kw in ({"radius": 5}, {"use_float64": True}, {}):
        assert torch.isfinite(port_rmi.rmi_lower_bound_cmajor(oh, pr, **kw))
    assert (port_rg.gram18_launches, port_rg.residual_launches) == (0, 0)  # no launch on the CPU
    with pytest.raises(ValueError, match="cuda or cpu"):
        port_rg.gram18(torch.zeros(1, 4, 4, device="meta"), torch.zeros(1, 4, 4, device="meta"))
    assert port_fast.FastRMIHieraTripletLoss(PH, rmi_precision="fast").rmi_precision == "fast"
    with pytest.raises(NotImplementedError, match="not yet ported"):
        port_fast.FastRMIHieraTripletLoss(PH, hiera_variant="focal")


def test_rmi_route_takes_the_kernels_only_at_shapes_their_launch_takes():
    """``rmi_backend: auto`` on the card picks the kernels only where their
    launch takes the shape (``kernel_shape_ok``): at most 65535 maps (they
    lie along gridDim.y) of fewer than 2^31 floats (32-bit offsets in a
    map). Past either limit it falls through to streaming or the
    materialized op, which compute a value, as JAX's Pallas kernel does at
    any shape. The tiles of a map lie along gridDim.x (up to 2^31 − 1), so
    a map with more row tiles than the launch takes is past the float
    limit too, and the 65535 row bands the earlier #7 launch allowed are no
    limit now. ``backend: pallas`` asks for the kernels by name, and the
    wrapper raises at such a shape. Only the shape is read: nothing is
    allocated."""
    cuda = torch.device("cuda")

    def auto(shape):
        return port_rmi.rmi_route(shape, 3, False, "auto", "auto", cuda)

    assert auto((4, 15, 512, 512)) == "kernels"  # config 3
    assert auto((2, 15, 769, 769)) == "kernels"  # config 4
    assert auto((1, 65535, 8, 8)) == "kernels"
    assert auto((1, 65536, 8, 8)) != "kernels"  # 65536 maps
    assert auto((256, 256, 8, 8)) != "kernels"
    assert auto((1, 1, 2**16, 2**15)) != "kernels"  # a map of 2^31 floats
    assert auto((1, 1, 2**16, 2**15 - 1)) == "kernels"
    th = port_rg.RES_TILE_H
    assert auto((1, 1, th * 2**31 + 3, 3)) != "kernels"  # 2^31 row tiles of #7 / #7f
    assert auto((1, 1, th * 65535 + 3, 3)) == "kernels"  # 65536 row tiles
    assert port_rmi.rmi_route((1, 65536, 8, 8), 3, False, "auto", "pallas", cuda) == "kernels"
    for shape in ((65536, 3, 3), (1, 2**16, 2**15)):
        maps = torch.empty(shape, device="meta")
        with pytest.raises(ValueError, match="at most 65535 maps"):
            port_rg._check_maps(maps, maps, "rmi gram18")


CU = os.path.join(os.path.dirname(__file__), os.pardir, "seghiero_torch", "csrc", "rmi_gram.cu")


def _cu_ints(names):
    """The ``constexpr int`` constants ``names`` of csrc/rmi_gram.cu, their
    expressions evaluated in order."""
    with open(CU) as f:
        src = f.read()
    vals = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", src):
        try:
            vals[name] = int(eval(expr.replace("/", "//"), {"__builtins__": {}}, dict(vals)))
        except (NameError, SyntaxError, TypeError):
            pass
    return [vals[n] for n in names]


def test_kernel_shape_ok_is_the_launch_check_of_the_source():
    """``kernel_shape_ok`` holds the limits of csrc/rmi_gram.cu ``shape_ok``:
    its body, read from the source and evaluated in Python, agrees with the
    wrapper's check on both sides of each limit."""
    with open(CU) as f:
        body = re.search(r"inline bool shape_ok\(int BC, int H, int W\) \{\s*return ([^;]+);",
                         f.read()).group(1)
    expr = re.sub(r"static_cast<long long>\((\w+)\)", r"\1", " ".join(body.split()))
    expr = expr.replace("1LL", "1").replace("&&", " and ")
    for BC, H, W in ((1, 3, 3), (port_rg.MAX_MAPS, 8, 8), (port_rg.MAX_MAPS + 1, 8, 8),
                     (1, 2**16, 2**15 - 1), (1, 2**16, 2**15), (1, 2**31 - 1, 3),
                     (1, 3, port_rg.MAX_MAP_FLOATS // 3), (1, 3, port_rg.MAX_MAP_FLOATS // 3 + 1)):
        want = eval(expr, {"__builtins__": {}}, {"BC": BC, "H": H, "W": W})
        assert port_rg.kernel_shape_ok(BC, H, W) == want, (BC, H, W)


@pytest.mark.parametrize("shape", [(3, 18, 20), (2, 37, 131), (1, 5, 300), (1, 3, 3),
                                   (1, 67, 769)])
def test_residual_f32_tiles_and_staged_chunks_cover_each_pixel_once(shape):
    """Kernel #7's geometry (csrc/rmi_gram.cu ``residual_f32_kernel``), its
    constants read from the source: tiles of kResTileH × kResTileW output
    pixels, one per block along gridDim.x (``residual_tiles`` is the
    wrapper's count); each input row of a tile (its rows and the 2 halo
    rows) staged as kF32Chunks 16-byte chunks from the one holding the
    tile's first column, a chunk copied only where it holds a needed column
    (and so a float of the maps), else zeros; kF32Threads threads reading
    6 staged floats each at the row's offset in its first chunk. With the
    maps starting 0, 1 or 3 floats into a 16-byte chunk (so rows of any
    width start anywhere in one) and NaN outside them, every output pixel
    is one thread's exactly once, and the Gram of the staged values is the
    plain version's in f64."""
    TH, TW, V, T, NQ = _cu_ints(("kResTileH", "kResTileW", "kF32Cols", "kF32Threads",
                                 "kF32Chunks"))
    assert T * V == TW and 4 * NQ >= 3 + TW + 2
    assert (port_rg.RES_TILE_H, port_rg.RES_TILE_W) == (TH, TW)
    BC, H, W = shape
    nh, nw, n = H - 2, W - 2, BC * H * W
    ntc, ntr = -(-nw // TW), -(-nh // TH)
    assert port_rg.residual_tiles(H, W) == ntc * ntr
    rng = np.random.default_rng(sum(shape))
    la = (rng.random(shape) < 0.3).astype(np.float64)
    pr = rng.random(shape) + 1e-6
    w = rng.standard_normal((BC, 9, 9)) * 0.3
    want = port_rg.residual_gram_plain(*map(torch.from_numpy, (la, pr, w))).numpy()
    cols = np.arange(TW)
    for lead_a, lead_p in ((0, 0), (1, 3), (3, 1)):
        maps = []
        for m, lead in ((la, lead_a), (pr, lead_p)):
            flat = np.full(lead + n + 4, np.nan)  # the allocation's last chunk
            flat[lead:lead + n] = m.ravel()
            maps.append((flat, lead))
        cover = np.zeros((BC, nh, nw), dtype=np.int64)
        got = np.zeros((BC, 9, 9))
        for bc, blk in itertools.product(range(BC), range(ntc * ntr)):
            tr, tc = divmod(blk, ntc)
            c0, r0 = tc * TW, tr * TH
            n_out, need = min(TH, nh - r0), min(TW + 2, W - c0)
            staged = []  # per map, the input rows as the threads read them
            for flat, lead in maps:
                rows = []
                for s in range(n_out + 2):
                    g = lead + bc * H * W + (r0 + s) * W + c0  # column c0's float
                    off = g % 4
                    row = np.zeros(4 * NQ)
                    for q in range(NQ):
                        if 4 * q < off + need:
                            lo = g - off + 4 * q
                            assert lo < g + need and lo + 4 > lead and lo < lead + n
                            row[4 * q:4 * q + 4] = flat[lo:lo + 4]
                    rows.append(row[off:off + TW + 2])  # thread t: [4t, 4t + 6)
                staged.append(rows)
            for o in range(n_out):
                valid = c0 + cols < nw  # the thread's nvalid columns
                za, zp = (np.stack([rows[o + dy][dx:dx + TW][valid] for dy in range(3)
                                    for dx in range(3)]) for rows in staged)
                y = za - w[bc].T @ zp
                got[bc] += y @ y.T
                cover[bc, r0 + o, c0 + cols[valid]] += 1
        assert (cover == 1).all(), (lead_a, lead_p)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _loss_inputs(seed, B=2, h=8, w=8, D=16):
    rng = np.random.default_rng(seed)
    lo = (rng.standard_normal((B, 15, h, w)) * 2).astype(np.float32)
    emb = rng.standard_normal((B, D, h // 4, w // 4)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return lo, emb, _labels(rng, B, 4 * h, 4 * w)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_fast_rmi_hiera_triplet_loss_matches_jax(backend):
    """The whole 3-level composite, value and d(logits), d(embedding),
    mid-schedule so the triplet term is live: ``xla`` against JAX's
    materialized RMI, ``pallas`` (the port's plain kernels) against JAX's
    Pallas kernels in interpret mode."""
    lo, emb, labels = _loss_inputs(8)
    step = 30_000  # the ramp of the 60k-step schedule is non-zero here
    jloss = jax_fast.FastRMIHieraTripletLoss(JH, rmi_backend=backend, hiera_precision="parity",
                                            pallas_interpret=backend == "pallas")

    def f(lo_, emb_):
        return jloss(jnp.int32(step), jnp.transpose(emb_, (0, 2, 3, 1)), None,
                     jnp.transpose(lo_, (0, 2, 3, 1)), jnp.asarray(labels))

    v, (g_lo, g_emb) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(jnp.asarray(lo),
                                                                      jnp.asarray(emb))
    ploss = port_fast.FastRMIHieraTripletLoss(PH, rmi_backend=backend)
    assert ploss.schedule_total_steps == 60_000
    lo_t, emb_t = torch.from_numpy(lo).requires_grad_(), torch.from_numpy(emb).requires_grad_()
    got = ploss(step, emb_t, None, lo_t, torch.from_numpy(labels))
    got.backward()
    # f32 sums in other orders; torch's and XLA's bilinear resizes round
    # differently; the RMI logdet amplifies rounding (test_rmi_core_matches_jax)
    np.testing.assert_allclose(got.item(), float(v), rtol=1e-5)
    np.testing.assert_allclose(lo_t.grad.numpy(), np.asarray(g_lo), rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(emb_t.grad.numpy(), np.asarray(g_emb), rtol=1e-4, atol=1e-7)
    assert np.abs(emb_t.grad.numpy()).max() > 0  # the triplet term is live


def test_fused_loss_knob_is_ignored_on_the_cpu_for_three_levels():
    lo, emb, labels = _loss_inputs(9)
    args = (100, torch.from_numpy(emb), None, torch.from_numpy(lo), torch.from_numpy(labels))
    a = port_fast.FastRMIHieraTripletLoss(PH, use_kernel=True)(*args)
    b = port_fast.FastRMIHieraTripletLoss(PH)(*args)
    assert float(a) == float(b)
