"""Multi-head attention of MiT's blocks: full-resolution queries against
the spatially reduced keys and values (the port of the two einsums and
the softmax of ``seghiero_tpu/models/mit.py`` ``EfficientAttention``).

``sr_attention(q, k, v)`` takes ``q [B, h, N, d]`` and ``k, v [B, h, M,
d]`` of one dtype and returns ``softmax(q·kᵀ/√d)·v`` ``[B, h, N, d]``:

* on the card, ``F.scaled_dot_product_attention`` held to the flash and
  memory-efficient backends (``sdpa_kernel``), so the ``N × M`` score
  matrix (65 536 × 1 024 at MiT's first stage of a 1024² image) is never
  materialised; a call neither backend takes raises instead of falling
  back to the math path;
* on the CPU, the plain path: the scores, their softmax in f32, rounded
  to the operands' dtype, times v — the JAX package's arithmetic.

Both backends take the softmax in f32. Any other device raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from seghiero_torch.ops import _build

# calls in this process (set to 0 to count a run): forwards on the card,
# and the backwards autograd ran through them
launches = 0
bwd_launches = 0
COUNTERS = ("launches", "bwd_launches")


def sr_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The scores ``q·kᵀ`` in the operands' dtype, scaled and softmaxed in
    f32, rounded back, times v."""
    scores = torch.matmul(q, k.transpose(-1, -2)).to(torch.float32)
    p = torch.softmax(scores * q.shape[-1] ** -0.5, dim=-1).to(q.dtype)
    return torch.matmul(p, v)


class _CountBackward(torch.autograd.Function):
    """Identity on the attention's output whose backward counts once."""

    @staticmethod
    def forward(ctx, out):
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        global bwd_launches
        bwd_launches += 1
        return g


def sr_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q·kᵀ/√d)·v`` for ``q [B, h, N, d]``, ``k, v [B, h, M,
    d]``: the flash or memory-efficient kernel on the card, the plain
    path on the CPU."""
    if not _build.on_card(q, "sr_attention"):
        return sr_attention_plain(q, k, v)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
        out = F.scaled_dot_product_attention(q, k, v)
    global launches
    launches += 1
    if out.requires_grad:
        out = _CountBackward.apply(out)
    return out
