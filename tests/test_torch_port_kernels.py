"""The port's two kernel modules against the JAX package.

On the CPU each wrapper runs its plain PyTorch version (the kernel's exact
arithmetic), which is held here against the Pallas kernel run in
interpret mode and against JAX's library ops; the CUDA kernels themselves
are held against the plain versions by tests/test_torch_port_cuda.py (on
the card) and by chip_smoke.py at the serving shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    port_ua.launches = 0
    port_dw.depthwise3x3(torch.zeros(1, 4, 4, 3), torch.zeros(9, 3))
    port_ua.upsample_argmax(torch.zeros(1, 3, 2, 2), [(0, 3)])
    assert port_dw.launches == 0 and port_ua.launches == 0
    with pytest.raises(ValueError, match="cuda or cpu"):
        port_dw.depthwise3x3(torch.zeros(1, 4, 4, 3, device="meta"),
                             torch.zeros(9, 3, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        port_ua.upsample_argmax(torch.zeros(1, 3, 2, 2, device="meta"), [(0, 3)])
