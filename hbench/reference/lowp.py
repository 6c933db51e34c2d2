"""The correctness control's precision: the reference with every
convolution's operands in fp8, the step below the bf16 the configurations
state. Activations and weights are rounded to e4m3 on the way in and the
gradients flowing back to e5m2, each tensor with its own scale (its
largest magnitude at the format's largest finite value), as an fp8
training recipe does; products and sums stay f32. A program that drops
to this precision has to fail the comparison (``hbench/limits/``).
"""

from __future__ import annotations

import contextlib

import torch

_STATE = {"mode": None}
E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def enabled() -> bool:
    """Whether the control's fp8 is on."""
    return _STATE["mode"] == "fp8"


def mode():
    """``fp8`` (the control), ``bf16`` (the witness's stores) or None."""
    return _STATE["mode"]


@contextlib.contextmanager
def _set(mode_):
    prev = _STATE["mode"]
    _STATE["mode"] = mode_
    try:
        yield
    finally:
        _STATE["mode"] = prev


def fp8():
    """Run the reference in the control's precision inside this block."""
    return _set("fp8")


def bf16_stores():
    """Round what the configuration stores in bf16 to bf16 inside this
    block (convolutions untouched): with a bf16-autocast forward pass, the
    witness that computes as the configuration states."""
    return _set("bf16")


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Q8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def q8(x: torch.Tensor) -> torch.Tensor:
    return _Q8.apply(x)
