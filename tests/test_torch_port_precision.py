"""``training.hiera_precision: fast`` in the port against the JAX package.

Under ``fast`` the JAX fast losses store the low-res logits and their
upsample in bf16 (``seghiero_tpu/losses/fast.py`` ``store_dt``), and every
consumer upcasts to f32. The same inputs (numpy, from a seed) go through
both packages with the knob set, for an f32 and a bf16 model (logits handed
over in that type): the upsampled bf16 tensor, the 2-level unfused loss,
the 3-level loss (``rmi_backend: xla``) and the aux CE, values and
gradients. No Pallas kernel runs here (the fused loss is f32 only, and the
config refuses ``fast`` with it).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_losses import JH as JH2, PH as PH2, _inputs
from test_torch_port_rmi import JH as JH3, PH as PH3, _loss_inputs
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from seghiero_torch import config as port_config
from seghiero_torch.losses import fast as port_fast
from seghiero_torch.ops.resize import resize_bilinear_bf16
from seghiero_tpu import config as jax_config
from seghiero_tpu.losses import fast as jax_fast

DTYPES = ["float32", "bfloat16"]
# the JAX side's compile dominates these tests; LLVM's backend
# optimizations only slow it down at these sizes (and halve their time off)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _jnp(x, dtype):
    return jnp.asarray(x).astype(jnp.dtype(dtype))


def _torch(x, dtype):
    return torch.from_numpy(np.asarray(x)).to(getattr(torch, dtype))


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.detach().float().numpy()


def _assert_grad_close(got, want):
    """Gradients through bf16 storage: each cotangent is rounded to bf16
    where JAX rounds it, but sums reach those roundings in another order,
    so an entry can land one bf16 ulp (2^-8 relative) away, and that
    difference travels on through the resize's transpose. Held within
    2^-7 relative per entry, plus 2^-8 of the largest entry."""
    got, want = _f32(got), _f32(want)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=2.0 ** -8 * np.abs(want).max())


@pytest.mark.parametrize("shape,size", [((2, 13, 8, 8), (32, 32)),
                                        ((1, 3, 193, 193), (769, 769)),
                                        ((2, 15, 9, 7), (33, 29))],
                         ids=["4x", "config4", "ragged"])
def test_bf16_upsample_equals_jax_bits(shape, size):
    """``resize_bilinear_bf16`` equals ``jax.image.resize`` of a bf16 array
    bit for bit: at 4×, at config 4's 193 → 769 and at uneven ratios."""
    x = (np.random.default_rng(0).standard_normal(shape) * 3).astype(np.float32)
    want = jax.jit(lambda a: jax_fast._resize_cmajor(a.astype(jnp.bfloat16), size))(
        jnp.asarray(x))
    got = resize_bilinear_bf16(torch.from_numpy(x), size)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), _f32(want))


@functools.lru_cache(maxsize=None)
def _jax_composite(levels: int):
    """The JAX composite with ``hiera_precision: fast`` (3 levels:
    ``rmi_backend: xla``), value and gradients in (logits, embedding),
    jitted once for both dtypes of a test: f32 logits ``[B, C, h, w]``.
    A bf16 model hands the loss bf16 logits, which the loss's first
    operation (``astype(bfloat16)``) leaves as they are; the same call on
    those values in f32 gives the same value, and the same gradient once
    rounded to bf16 (the cotangent of that ``astype`` is the bf16 one)."""
    if levels == 2:
        loss = jax_fast.FastHieraTripletLoss(JH2, use_pallas=False, hiera_precision="fast")
    else:
        loss = jax_fast.FastRMIHieraTripletLoss(JH3, rmi_backend="xla", hiera_precision="fast")

    def f(lo, emb, labels, step):
        return loss(step, jnp.transpose(emb, (0, 2, 3, 1)), None,
                    jnp.transpose(lo, (0, 2, 3, 1)), labels)

    return jax.jit(jax.value_and_grad(f, argnums=(0, 1)), compiler_options=FAST_COMPILE)


def _check_composite(levels: int, dtype: str, lo, emb, labels, step, port_loss):
    """The port's composite against ``_jax_composite`` on the same inputs,
    the logits in ``dtype``: value within 1e-5 relative (f32 sums over the
    same bf16 logits in another order), d(logits) as
    ``_assert_grad_close`` states, d(embedding) within rtol 1e-4."""
    lo_in = _f32(_jnp(lo, dtype))  # a bf16 model's logits are bf16 values
    v, (g_lo, g_emb) = _jax_composite(levels)(jnp.asarray(lo_in), jnp.asarray(emb),
                                              jnp.asarray(labels), jnp.int32(step))
    lo_t = _torch(lo_in, dtype).requires_grad_()
    emb_t = torch.from_numpy(emb).requires_grad_()
    got = port_loss(step, emb_t, None, lo_t, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(v), rtol=1e-5)
    assert lo_t.grad.dtype == getattr(torch, dtype)
    _assert_grad_close(lo_t.grad, _jnp(g_lo, dtype))
    np.testing.assert_allclose(emb_t.grad.numpy(), np.asarray(g_emb), rtol=1e-4, atol=1e-7)
    return got.item(), lo_t.detach(), emb_t.detach()


@pytest.mark.parametrize("dtype", DTYPES)
def test_two_level_loss_fast_precision_matches_jax(dtype):
    """The 2-level unfused composite with ``hiera_precision: fast``
    (``_check_composite``), saturated logits included; the f32 path gives
    another value."""
    lo, emb, labels = _inputs(3, saturate=True)
    port = port_fast.FastHieraTripletLoss(PH2, hiera_precision="fast")
    v, lo_t, emb_t = _check_composite(2, dtype, lo, emb, labels, 1234, port)
    parity = port_fast.FastHieraTripletLoss(PH2)(1234, emb_t, None, lo_t,
                                                 torch.from_numpy(labels))
    assert parity.item() != v


@pytest.mark.parametrize("dtype", DTYPES)
def test_three_level_loss_fast_precision_matches_jax(dtype):
    """The 3-level composite (``rmi_backend: xla``) with ``hiera_precision:
    fast``: the hierarchy BCE, CE and RMI terms read the bf16 upsample
    (``_check_composite``)."""
    lo, emb, labels = _loss_inputs(8)
    port = port_fast.FastRMIHieraTripletLoss(PH3, rmi_backend="xla", hiera_precision="fast")
    _check_composite(3, dtype, lo, emb, labels, 30_000, port)


@functools.lru_cache(maxsize=None)
def _jax_aux_ce():
    def f(a, labels):
        return jax_fast.aux_ce_fast(jnp.transpose(a, (0, 2, 3, 1)), labels,
                                    hiera_precision="fast")

    return jax.jit(jax.value_and_grad(f), compiler_options=FAST_COMPILE)


@pytest.mark.parametrize("dtype", DTYPES)
def test_aux_ce_fast_precision_matches_jax(dtype):
    """``aux_ce_fast`` with ``hiera_precision: fast``: value within 1e-5
    relative, gradient as ``_assert_grad_close``."""
    rng = np.random.default_rng(6)
    aux = rng.standard_normal((2, 9, 4, 4)).astype(np.float32) * 2
    labels = rng.integers(0, 9, (2, 64, 64)).astype(np.int32)
    labels[:, :10] = 255

    a_in = _f32(_jnp(aux, dtype))  # as _jax_composite: one compile for both dtypes
    v, g = _jax_aux_ce()(jnp.asarray(a_in), jnp.asarray(labels))
    a_t = _torch(a_in, dtype).requires_grad_()
    got = port_fast.aux_ce_fast(a_t, torch.from_numpy(labels), hiera_precision="fast")
    got.backward()
    np.testing.assert_allclose(got.item(), float(v), rtol=1e-5)
    _assert_grad_close(a_t.grad, _jnp(g, dtype))


def test_fast_precision_with_the_fused_kernels_raises():
    """The fused kernels are f32 only: a config asking for them with bf16
    storage raises in both packages, and one that leaves the knob unset
    resolves it to ``parity``."""
    for config in (port_config, jax_config):
        with pytest.raises(ValueError, match="mutually exclusive"):
            config.TrainingConfig.from_dict({"hiera_precision": "fast",
                                             "pallas_fused_loss": True})
        t = config.TrainingConfig.from_dict({"pallas_fused_loss": True})
        assert t.hiera_precision == "parity"
