"""The port's two kernel modules against the JAX package.

On the CPU each wrapper runs its plain PyTorch version (the kernel's exact
arithmetic), which is held here against the Pallas kernel run in
interpret mode and against JAX's library ops; the CUDA kernels themselves
are held against the plain versions by tests/test_torch_port_cuda.py (on
the card) and by chip_smoke.py at the serving shapes.
"""

import functools
import itertools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from seghiero_torch.infer.predictor import decode_masks
from seghiero_torch.ops import depthwise as port_dw
from seghiero_torch.ops import upsample_argmax as port_ua
from seghiero_tpu.ops.pallas.depthwise import depthwise3x3 as jax_depthwise3x3
from seghiero_tpu.ops.pallas.upsample_argmax import fused_upsample_argmax


def _bf16_ulp(x: np.ndarray) -> float:
    """One bf16 ulp (8 significant bits) at the largest magnitude of x."""
    m = float(np.max(np.abs(x)))
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def _jax_grouped_conv(x, k9):
    C = x.shape[-1]
    return jax.lax.conv_general_dilated(
        x, k9.reshape(3, 3, 1, C), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=C,
    )


# odd channel counts and spatial sizes that are not multiples of 8
DW_SHAPES = [(2, 13, 11, 3), (1, 9, 20, 130), (2, 8, 16, 16)]


@pytest.mark.parametrize("shape", DW_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_depthwise_plain_matches_pallas_and_grouped_conv(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    k9 = (rng.standard_normal((9, shape[-1])) * 0.5).astype(np.float32)
    jdt = jnp.dtype(dtype)
    xj, kj = jnp.asarray(x, jdt), jnp.asarray(k9, jdt)
    tdt = getattr(torch, dtype)
    # the same (already rounded) values on both sides
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    kt = torch.from_numpy(np.array(kj.astype(jnp.float32))).to(tdt)

    got = port_dw.depthwise3x3(xt, kt)
    assert got.dtype == tdt and tuple(got.shape) == shape
    got = got.float().numpy()
    pallas = np.asarray(jax_depthwise3x3(xj, kj, True).astype(jnp.float32))
    lax = np.asarray(_jax_grouped_conv(xj, kj).astype(jnp.float32))
    if dtype == "float32":
        # same 9-term f32 sum in the same order as the Pallas kernel; XLA's
        # grouped conv sums in its own order (a few f32 ulps at |y| ≲ 8)
        np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got, lax, rtol=0, atol=1e-6)
    else:
        # both round one f32 sum to bf16: at most 1 bf16 ulp apart where
        # the f32 sums differ in their last bits across a rounding boundary
        np.testing.assert_allclose(got, pallas, rtol=0, atol=_bf16_ulp(pallas))
        np.testing.assert_allclose(got, lax, rtol=0, atol=_bf16_ulp(lax))


def test_depthwise_matches_grouped_conv_in_torch():
    """The plain version is the same function as F.conv2d(groups=C) — the
    library op the port's ``xla`` backend uses."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 10, 7, 5)).astype(np.float32))
    k9 = torch.from_numpy(rng.standard_normal((9, 5)).astype(np.float32))
    want = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), k9.t().reshape(5, 1, 3, 3), padding=1, groups=5
    ).permute(0, 2, 3, 1)
    torch.testing.assert_close(port_dw.depthwise3x3(x, k9), want, rtol=0, atol=1e-6)


@functools.partial(jax.jit, static_argnums=2)
def _jax_dilated_conv(x, k9, d):
    C = x.shape[-1]
    return jax.lax.conv_general_dilated(
        x, k9.reshape(3, 3, 1, C), (1, 1), ((d, d), (d, d)), rhs_dilation=(d, d),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=C,
    )


# the ASPP's dilated branches: d ≥ H/2 puts whole tap rows and columns in
# the padding (d = 36 on 40 rows: every row loses one), odd C and C that is
# not a multiple of 8, H and W not multiples of d
DILATED_CASES = [((2, 9, 7, 3), 2), ((1, 13, 11, 10), 12), ((1, 40, 38, 5), 36)]


@pytest.mark.parametrize("shape,d", DILATED_CASES, ids=[f"d{d}" for _, d in DILATED_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dilated_depthwise_plain_matches_jax_dilated_conv(shape, d, dtype):
    """The dilated forward's plain version (kernel #9's arithmetic) against
    the JAX package's own path for these branches, XLA's dilated grouped
    convolution."""
    rng = np.random.default_rng(sum(shape) + d)
    x = rng.standard_normal(shape).astype(np.float32)
    k9 = (rng.standard_normal((9, shape[-1])) * 0.5).astype(np.float32)
    jdt = jnp.dtype(dtype)
    xj, kj = jnp.asarray(x, jdt), jnp.asarray(k9, jdt)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    kt = torch.from_numpy(np.array(kj.astype(jnp.float32))).to(tdt)

    got = port_dw.depthwise3x3_dilated_forward(xt, kt, d)
    assert got.dtype == tdt and tuple(got.shape) == shape
    assert torch.equal(got, port_dw.depthwise3x3_dilated_plain(xt, kt, d))
    got = got.float().numpy()
    want = np.asarray(_jax_dilated_conv(xj, kj, d).astype(jnp.float32))
    # as the dilation-1 test: f32 sums in XLA's order, or one bf16 rounding
    atol = 1e-6 if dtype == "float32" else _bf16_ulp(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _logits(rng, shape, dtype):
    lo = rng.standard_normal(shape).astype(np.float32)
    # planted ties: equal channels blend to equal values, so the first of
    # them must win — in the fine slice, across levels, and in the coarse
    lo[:, 4] = lo[:, 2]
    lo[:, 7] = lo[:, 2]
    lo[:, 10] = lo[:, 9]
    lo[:, :, :2, :3] = 0.5  # a block where every channel ties
    jl = jnp.asarray(lo, jnp.dtype(dtype))
    return jl, torch.from_numpy(np.array(jl.astype(jnp.float32))).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape,slices",
    [
        ((2, 13, 6, 10), [(0, 9), (9, 13)]),  # 2-level, h and w not multiples of 8
        ((1, 15, 8, 12), [(0, 9), (9, 13), (13, 15)]),  # 3-level
    ],
)
def test_upsample_argmax_plain_equals_pallas(dtype, shape, slices):
    rng = np.random.default_rng(shape[2] * 100 + shape[3])
    jl, tl = _logits(rng, shape, dtype)
    want = fused_upsample_argmax(jl, slices, interpret=True)
    got = port_ua.upsample_argmax(tl, slices)
    assert len(got) == len(slices)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == (shape[0], 4 * shape[2], 4 * shape[3])
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the all-equal block decodes to the first channel of every level
    for g in got:
        assert int(g[:, :4, :8].max()) == 0


def _decode_threads() -> int:
    """Low-res pixels of one row a block of csrc/upsample_argmax.cu."""
    path = os.path.join(os.path.dirname(__file__), os.pardir, "seghiero_torch", "csrc",
                        "upsample_argmax.cu")
    with open(path) as f:
        return int(re.search(r"constexpr int kThreads = (\d+);", f.read()).group(1))


def _decode_per_lowres_pixel(logits, slices):
    """The CUDA decode's form: each low-res pixel (b, i, j) loads its
    clamped 3×3 neighbourhood per channel, blends its 3 tap rows at the 4
    column phases (12 horizontal blends ``ax·t[r][c] + bx·t[r][c+1]``),
    then the 16 outputs from two of them (``ay·h[ro] + by·h[ro+1]``), f32,
    one operation at a time, and keeps 16 running (best, index) pairs per
    level, taking a later channel only when strictly larger; written as
    output rows 4i … 4i+3, columns 4j … 4j+3. Every pixel at once, each
    with only its own values."""
    B, C, h, w = logits.shape
    x = logits.to(torch.float32)
    ri, cj = torch.arange(h), torch.arange(w)
    rows = ((ri - 1).clamp(min=0), ri, (ri + 1).clamp(max=h - 1))
    cols = ((cj - 1).clamp(min=0), cj, (cj + 1).clamp(max=w - 1))
    t = [[x[:, :, r][:, :, :, c] for c in cols] for r in rows]  # [B, C, h, w] each
    hb = [[ax * t[r][co] + bx * t[r][co + 1] for co, ax, bx in port_ua.PHASE] for r in range(3)]
    v = [[ay * hb[ro][px] + by * hb[ro + 1][px] for px in range(4)]
         for ro, ay, by in port_ua.PHASE]
    outs = []
    for lo, hi in slices:
        out = torch.empty((B, h, 4, w, 4), dtype=torch.int32)
        for py, px in itertools.product(range(4), range(4)):
            best = v[py][px][:, lo]
            idx = torch.zeros_like(best, dtype=torch.int32)
            for c in range(lo + 1, hi):
                take = v[py][px][:, c] > best
                best = torch.where(take, v[py][px][:, c], best)
                idx = torch.where(take, c - lo, idx)
            out[:, :, py, :, px] = idx
        outs.append(out.reshape(B, 4 * h, 4 * w))
    return outs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["2-level", "3-level", "h=1", "w=1", "ragged"])
def test_upsample_argmax_shared_blends_equal_the_plain_version(dtype, case):
    """Kernel #3's form (one thread per low-res pixel, its 12 horizontal
    blends shared by the 16 outputs) gives the plain version's masks bit
    for bit, in f32 and bf16, at 2 and 3 levels, with h or w of 1 and a
    width one block and 3 low-res pixels wide (the block's threads read
    from the .cu); channels 2 and 4 tie everywhere."""
    two, three = [(0, 9), (9, 13)], [(0, 9), (9, 13), (13, 15)]
    shape, slices = {"2-level": ((2, 13, 6, 10), two), "3-level": ((1, 15, 5, 7), three),
                     "h=1": ((2, 15, 1, 9), three), "w=1": ((2, 13, 7, 1), two),
                     "ragged": ((1, 15, 3, _decode_threads() + 3), three)}[case]
    gen = torch.Generator().manual_seed(shape[2] * 1000 + shape[3])
    lo = torch.randn(shape, generator=gen).to(dtype)
    lo[:, 4] = lo[:, 2]
    got = _decode_per_lowres_pixel(lo, slices)
    want = port_ua.upsample_argmax_plain(lo, slices)
    assert len(got) == len(want) == len(slices)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_port_library_decode_agrees_with_jax_decode():
    """The ``xla`` decode of both packages (bilinear resize + argmax): the
    two resize implementations round differently, so argmax may flip where
    two upsampled logits are within float rounding of each other."""
    rng = np.random.default_rng(3)
    shape, slices = (2, 13, 16, 24), {"fine": (0, 9), "coarse": (9, 13)}
    lo = rng.standard_normal(shape).astype(np.float32)
    out_hw = (64, 96)
    up = jax.image.resize(jnp.asarray(lo), (*shape[:2], *out_hw), "linear", antialias=False)
    for backend in ("xla", "pallas"):
        got = decode_masks(torch.from_numpy(lo), out_hw, slices, backend)
        for lvl, (a, b) in slices.items():
            want = np.asarray(jnp.argmax(up[:, a:b], axis=1))
            assert (got[lvl].numpy() == want).mean() >= 0.999
    # a non-4× output always takes the library path, whatever the backend
    odd = decode_masks(torch.from_numpy(lo), (50, 70), slices, "pallas")
    assert tuple(odd["fine"].shape) == (2, 50, 70)


def test_cpu_tensors_never_count_launches_and_other_devices_raise():
    port_dw.launches = 0
    port_dw.dilated_launches = 0
    port_ua.launches = 0
    port_dw.depthwise3x3(torch.zeros(1, 4, 4, 3), torch.zeros(9, 3))
    port_dw.depthwise3x3_dilated_forward(torch.zeros(1, 4, 4, 3), torch.zeros(9, 3), 2)
    port_ua.upsample_argmax(torch.zeros(1, 3, 2, 2), [(0, 3)])
    assert port_dw.launches == 0 and port_dw.dilated_launches == 0 and port_ua.launches == 0
    with pytest.raises(ValueError, match="cuda or cpu"):
        port_dw.depthwise3x3_dilated_forward(torch.zeros(1, 4, 4, 3, device="meta"),
                                             torch.zeros(9, 3, device="meta"), 2)
    with pytest.raises(ValueError, match="dilation"):
        port_dw.depthwise3x3_dilated_forward(torch.zeros(1, 4, 4, 3), torch.zeros(9, 3), 0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        port_dw.depthwise3x3(torch.zeros(1, 4, 4, 3, device="meta"),
                             torch.zeros(9, 3, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        port_ua.upsample_argmax(torch.zeros(1, 3, 2, 2, device="meta"), [(0, 3)])


def test_every_benchmark_counter_is_a_launch_count():
    """Each ``hbench/kernels/*.py`` ``COUNTER`` names a counter that
    ``ops.launch_counts`` reads, so a replayed train step advances it."""
    from hbench.core import spec
    from seghiero_torch import ops

    counters = {".".join(k.COUNTER) for k in spec.Bench().kernels().values()}
    assert counters and counters <= set(ops.launch_counts()), counters - set(ops.launch_counts())


def test_every_launch_counter_is_listed_in_its_modules_counters():
    """Each module-level int of ``seghiero_torch/ops/*.py`` named
    ``*launches`` or ``backward_copies`` is in its module's ``COUNTERS``,
    and that module is one ``ops.COUNTED`` reads."""
    import importlib
    from pathlib import Path

    from seghiero_torch import ops

    found = {}
    for path in sorted(Path(ops.__file__).parent.glob("*.py")):
        if path.stem == "__init__":
            continue
        mod = importlib.import_module(f"seghiero_torch.ops.{path.stem}")
        names = {k for k, v in vars(mod).items() if type(v) is int
                 and (k.endswith("launches") or k == "backward_copies")}
        if names:
            found[mod] = names
            assert mod in ops.COUNTED, mod.__name__
            assert names == set(mod.COUNTERS), (mod.__name__, names ^ set(mod.COUNTERS))
    assert set(found) == set(ops.COUNTED)
