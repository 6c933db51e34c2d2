"""The training path's kernel modules against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; here those are
held against the Pallas kernels run in interpret mode: the depthwise
convolution's VJP (input gradient through the flipped-tap forward,
weight gradient) and the fused upsample + hierarchy-BCE + CE sums with
their gradient. The CUDA kernels are held against the plain versions by
tests/test_torch_port_cuda.py (on the card) and by chip_smoke.py at the
training shapes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from seghiero_torch.hierarchy import Hierarchy as PortHierarchy
from seghiero_torch.losses.hiera import prepare_targets_two_level as port_targets
from seghiero_torch.ops import depthwise as port_dw
from seghiero_torch.ops import hiera2_fused as port_fused
from seghiero_tpu.hierarchy import Hierarchy as JaxHierarchy
from seghiero_tpu.losses.hiera import prepare_targets_two_level as jax_targets
from seghiero_tpu.ops.pallas.depthwise import depthwise3x3 as jax_depthwise3x3
from seghiero_tpu.ops.pallas.hiera2_fused import fused_hiera2_loss_sums as jax_fused

CLASSES = {
    "coarse_to_fine_map": [[0, 3], [4, 6], [7], [8]],
    "coarse_names": {0: "a", 1: "b", 2: "c", 3: "d"},
    "fine_names": {i: f"f{i}" for i in range(9)},
}
# 3 fine classes in 2 coarse ones (a two-child bucket and a one-child
# bucket): the fused kernel's interpret-mode program grows with the class
# count, and at the 13 channels of CLASSES its value-and-grad compiles for
# two minutes on a CPU core; at 5 it takes a quarter of that. The 13-class
# layout is held against the JAX package's unfused path in
# test_torch_port_losses.py, and the CUDA kernels against these plain
# versions at 13 channels on the card.
SMALL_CLASSES = {
    "coarse_to_fine_map": [[0, 1], [2]],
    "coarse_names": {0: "a", 1: "b"},
    "fine_names": {i: f"f{i}" for i in range(3)},
}


def _bf16_ulp(x: np.ndarray) -> float:
    m = float(np.max(np.abs(x)))
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_depthwise_vjp_matches_pallas(dtype):
    """dx (the forward with reversed taps) and dk (the weight gradient) of
    the port's autograd Function against ``jax.vjp`` of the Pallas kernel
    in interpret mode, at [2, 32, 16, 8]."""
    rng = np.random.default_rng(11)
    shape = (2, 32, 16, 8)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    xj = jnp.asarray(rng.standard_normal(shape), jdt)
    kj = jnp.asarray(rng.standard_normal((9, 8)) * 0.5, jdt)
    gj = jnp.asarray(rng.standard_normal(shape), jdt)
    out_j, vjp = jax.vjp(lambda x, k: jax_depthwise3x3(x, k, True), xj, kj)
    dx_j, dk_j = (np.asarray(a.astype(jnp.float32)) for a in vjp(gj))

    def t(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)

    xt, kt, gt = t(xj).requires_grad_(), t(kj).requires_grad_(), t(gj)
    out_t = port_dw.depthwise3x3(xt, kt)
    out_t.backward(gt)
    assert xt.grad.dtype == tdt and kt.grad.dtype == tdt
    dx_t, dk_t = xt.grad.float().numpy(), kt.grad.float().numpy()
    if dtype == "float32":
        # dx: the same 9-term f32 sum in the same order on both sides
        np.testing.assert_allclose(dx_t, dx_j, rtol=0, atol=1e-6)
        # dk: sums of 1024 products in another order
        scale = np.abs(np.asarray(xj)).max() * np.abs(np.asarray(gj)).max() * 1024
        np.testing.assert_allclose(dk_t, dk_j, rtol=0, atol=1e-6 * scale)
    else:
        # both round one f32 sum to bf16: at most 1 bf16 ulp apart
        np.testing.assert_allclose(dx_t, dx_j, rtol=0, atol=_bf16_ulp(dx_j))
        np.testing.assert_allclose(dk_t, dk_j, rtol=0, atol=_bf16_ulp(dk_j))
    np.testing.assert_allclose(out_t.float().detach().numpy(),
                               np.asarray(out_j.astype(jnp.float32)), rtol=0,
                               atol=1e-6 if dtype == "float32" else _bf16_ulp(np.asarray(
                                   out_j.astype(jnp.float32))))


def test_depthwise_wgrad_plain_is_the_conv_weight_gradient():
    """The plain weight gradient equals autograd of F.conv2d(groups=C)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 7, 9, 5)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 7, 9, 5)).astype(np.float32))
    w = torch.zeros((5, 1, 3, 3), requires_grad=True)
    torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, padding=1, groups=5).backward(
        g.permute(0, 3, 1, 2))
    want = w.grad.reshape(5, 9).t()
    torch.testing.assert_close(port_dw.depthwise3x3_wgrad_plain(x, g), want,
                               rtol=0, atol=1e-5)


def _fused_case(kind: str):
    """lo [2, 5, 8, 16] and labels [2, 32, 64] for one test case."""
    rng = np.random.default_rng({"plain": 1, "saturated": 2, "ties": 3, "ignored": 4}[kind])
    h = JaxHierarchy.from_class_config(SMALL_CLASSES)
    lo = (rng.standard_normal((2, 5, 8, 16)) * 3).astype(np.float32)
    labels = rng.integers(0, 3, (2, 32, 64)).astype(np.int32)
    labels[:, :5, :7] = 255
    if kind == "saturated":
        lo = np.where(rng.random(lo.shape) < 0.05, np.sign(lo) * 40.0, lo).astype(np.float32)
    if kind == "ties":
        # l_f == l_coarse(f) for every fine channel on half the rows, and the
        # two children of coarse bucket 0 equal on the others (the bucket-max
        # chain)
        f2c = np.asarray(h.fine_to_coarse)
        for f in range(3):
            lo[:, f, ::2] = lo[:, 3 + f2c[f], ::2]
        lo[:, 1, 1::2] = lo[:, 0, 1::2]
    if kind == "ignored":
        labels[:] = 255
    return h, lo, labels


@functools.lru_cache(maxsize=1)
def _jax_fused_value_and_grad():
    """One jitted value-and-grad of ``g · sums`` through the Pallas kernel
    in interpret mode, shared by every case: one trace and compile (the
    unrolled 16-phase kernel bodies make a large program; LLVM's backend
    optimizations are switched off to shorten its compile, which dominates
    this file's time)."""
    h = JaxHierarchy.from_class_config(SMALL_CLASSES)

    def objective(x, labels, g):
        tf, tc = jax_targets(labels, h)
        sums = jnp.stack(jax_fused(x, tf, tc, h, interpret=True))
        return jnp.dot(g, sums), sums

    return jax.jit(
        jax.value_and_grad(objective, has_aux=True),
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True},
    )


@pytest.mark.parametrize("kind", ["plain", "saturated", "ties", "ignored"])
def test_fused_sums_and_gradient_match_pallas(kind):
    """The six sums and d lo against the Pallas kernel in interpret mode:
    sums within 1e-5 relative, d lo within rtol 2e-4 / atol 1e-7
    (tests/test_pallas_fused.py's tolerances)."""
    _, lo, labels = _fused_case(kind)
    g = np.array([0.3, -0.7, 0.0, 0.0, 1.1, 0.45], np.float32)
    (_, sums_j), dlo_j = _jax_fused_value_and_grad()(
        jnp.asarray(lo), jnp.asarray(labels), jnp.asarray(g))
    sums_j = np.asarray(sums_j, np.float64)

    ph = PortHierarchy.from_class_config(SMALL_CLASSES)
    tf_t, tc_t = port_targets(torch.from_numpy(labels), ph)
    lo_t = torch.from_numpy(lo).requires_grad_()
    sums_t = torch.stack(port_fused.fused_hiera2_loss_sums(lo_t, tf_t, tc_t, ph))
    (torch.from_numpy(g) * sums_t).sum().backward()
    got = sums_t.detach().numpy().astype(np.float64)
    np.testing.assert_allclose(got, sums_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lo_t.grad.numpy(), np.asarray(dlo_j), rtol=2e-4, atol=1e-7)
    assert np.all(np.isfinite(lo_t.grad.numpy()))
    if kind == "ignored":
        assert got[2] == got[3] == 0 and not lo_t.grad.abs().max()


def test_upsample4_plain_matches_interpolate():
    """The kernels' phase blend is torch's half-pixel bilinear 4× upsample
    (with edge clamp) up to f32 rounding."""
    lo = torch.randn(2, 3, 5, 7, generator=torch.Generator().manual_seed(0))
    want = torch.nn.functional.interpolate(lo, size=(20, 28), mode="bilinear",
                                           align_corners=False)
    torch.testing.assert_close(port_fused.upsample4_plain(lo), want, rtol=0, atol=1e-5)


def test_cpu_wrappers_count_no_launches_and_other_devices_raise():
    for name in ("launches", "dgrad_launches", "wgrad_launches"):
        setattr(port_dw, name, 0)
    port_fused.fwd_launches = port_fused.bwd_launches = 0
    x = torch.randn(1, 4, 4, 3, requires_grad=True)
    port_dw.depthwise3x3(x, torch.randn(9, 3, requires_grad=True)).sum().backward()
    h = PortHierarchy.from_class_config(CLASSES)
    lo = torch.randn(1, 13, 2, 2, requires_grad=True)
    t = torch.zeros(1, 8, 8, dtype=torch.int32)
    sum(port_fused.fused_hiera2_loss_sums(lo, t, t, h)).backward()
    assert (port_dw.launches, port_dw.dgrad_launches, port_dw.wgrad_launches) == (0, 0, 0)
    assert (port_fused.fwd_launches, port_fused.bwd_launches) == (0, 0)
    meta = torch.zeros(1, 13, 2, 2, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        port_fused.fused_hiera2_loss_sums(meta, t, t, h)
    with pytest.raises(ValueError, match="cuda or cpu"):
        port_dw.depthwise3x3_wgrad(torch.zeros(1, 4, 4, 3, device="meta"),
                                   torch.zeros(1, 4, 4, 3, device="meta"))


def test_hierarchy_table_walks_each_group_in_id_order():
    """The fused kernels' view of the hierarchy: where each coarse group
    starts in the walk, the walk (each group's coarse channel, then its
    fine children in id order, for groups that are not contiguous too)
    and the backward's schedule (each group's walk twice)."""
    h = PortHierarchy.from_class_config({"coarse_to_fine_map": [[0, 5], [2, 3], [5]],
                                         "fine_names": {i: f"f{i}" for i in range(6)}})
    assert h.fine_by_coarse == ((0, 1, 4), (2, 3), (5,))
    tab = port_fused.hierarchy_table(h)
    assert tab.dtype == np.int32
    goff, walk, bsched = tab[:4], tab[4:13], tab[13:]
    assert goff.tolist() == [0, 4, 7, 9]
    assert walk.tolist() == [6, 0, 1, 4, 7, 2, 3, 8, 5]
    assert bsched.tolist() == [6, 0, 1, 4, 6, 0, 1, 4, 7, 2, 3, 7, 2, 3, 8, 5, 8, 5]
