"""Multi-head attention of MiT's blocks: full-resolution queries against
the spatially reduced keys and values (the port of the two einsums and
the softmax of ``seghiero_tpu/models/mit.py`` ``EfficientAttention``);
and Swin's window attention with an additive bias (``window_attention``,
the port of ``seghiero_tpu/models/swin.py`` ``WindowAttention``'s).

``sr_attention(q, k, v)`` takes ``q [B, h, N, d]`` and ``k, v [B, h, M,
d]`` of one dtype and returns ``softmax(q·kᵀ/√d)·v`` ``[B, h, N, d]``:

* on the card, in bf16 with d ∈ {32, 64} (MiT-B0 to B5): the hand-written
  pair of ``csrc/sr_attention.cu`` (kernels #10, #10b) as one
  ``torch.autograd.Function``; its backward splits the queries as well as
  the keys (``backward_splits``), so that MiT's few keys (M = 1 024 at
  every stage of a 1024² image) and few heads still fill the card;
* on the card in any other dtype or head dimension (f32, say):
  ``F.scaled_dot_product_attention`` held to the flash and
  memory-efficient backends (``sdpa_kernel``); a call neither backend
  takes (f64) raises instead of falling back to the math path;
* on the CPU, the plain path: the scores, their softmax in f32, rounded
  to the operands' dtype, times v — the JAX package's arithmetic.

All take the softmax in f32. Any other device raises.
``sr_attention_lse`` and ``sr_attention_bwd_plain`` repeat the pair's own
backward arithmetic in plain PyTorch (the saved log-sum-exp, D, the query
splits summed in the kernel's order), for the CPU tests.

``window_attention(q, k, v, bias)`` takes ``q, k, v [B·nW, h, N, d]`` (the
``N = w²`` tokens of each of a batch's ``nW`` windows) and an additive
``bias`` broadcastable to ``[B·nW, h, N, N]`` (Swin's gathered
relative-position table, plus the shift's region mask) and returns
``softmax(q·kᵀ/√d + bias)·v``, with the bias's gradient:

* on the card: ``F.scaled_dot_product_attention`` with the bias as its
  ``attn_mask`` in q's dtype, held to the memory-efficient backend
  (``fmha_cutlassF`` / ``fmha_cutlassB``), the one backend that takes an
  additive mask and returns its gradient; a call it does not take (f64)
  raises instead of falling back to the math path;
* on the CPU, the plain path: the scores in the operands' dtype, scaled
  and biased in f32, their softmax in f32, rounded to the operands'
  dtype, times v.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch
import torch.nn.functional as F

from seghiero_torch.ops import _build

# calls in this process (set to 0 to count a run): forwards on the card,
# the backwards autograd ran through them, and the forwards on the card
# that the hand-written pair did not take (SDPA's)
launches = 0
bwd_launches = 0
sdpa_launches = 0
# window_attention's forwards on the card and the backwards through them
window_launches = 0
window_bwd_launches = 0
COUNTERS = ("launches", "bwd_launches", "sdpa_launches", "window_launches",
            "window_bwd_launches")

# the kernels' tile (kTile of csrc/sr_attention.cu): rows of a warpgroup,
# and of the tiles a block streams (keys in the forward and dq, queries in
# dk/dv)
TILE = 64
SMS = 132  # the H100's
# blocks of the dk/dv kernel that an SM holds at once (226 registers a
# thread, 128 threads a block)
DKDV_BLOCKS_PER_SM = 2
HEAD_DIMS = (32, 64)


def forward_rows(B: int, h: int, N: int) -> int:
    """Queries a forward block: 128 (two warpgroups sharing each streamed k
    and v tile) unless 64 (one) leaves less work on the busiest SM, the
    blocks dealt out over 132 SMs: ``ceil(blocks/132)·rows``."""
    busiest = {r: -(-(-(-N // r) * B * h) // SMS) * r for r in (128, 64)}
    return 64 if busiest[64] < busiest[128] else 128


@functools.lru_cache(maxsize=None)
def backward_splits(B: int, h: int, N: int, M: int) -> int:
    """Query splits of the dk/dv launch, from the shape alone: of 1 to the
    ``T = ceil(N/64)`` query tiles, the count S whose grid of
    ``ceil(M/64)·B·h·S`` blocks finishes in the fewest tile steps on the
    card's ``132 × 2`` block slots: ``waves · (ceil(T/S) + 1)``, a block's
    keys and its workspace rows costing about one tile; the fewest splits
    of equals."""
    blocks, tiles = -(-M // TILE) * B * h, -(-N // TILE)
    slots = SMS * DKDV_BLOCKS_PER_SM
    return min(range(1, tiles + 1),
               key=lambda s: (-(-s * blocks // slots) * (-(-tiles // s) + 1), s))


def split_bounds(N: int, splits: int) -> List[Tuple[int, int]]:
    """The query rows ``[lo, hi)`` of each split, in order: split s takes
    the 64-row tiles ``[s·T/splits, (s+1)·T/splits)`` of the ``T`` tiles."""
    tiles = -(-N // TILE)
    return [(s * tiles // splits * TILE, min(N, (s + 1) * tiles // splits * TILE))
            for s in range(splits)]


def sr_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The scores ``q·kᵀ`` in the operands' dtype, scaled and softmaxed in
    f32, rounded back, times v."""
    scores = torch.matmul(q, k.transpose(-1, -2)).to(torch.float32)
    p = torch.softmax(scores * q.shape[-1] ** -0.5, dim=-1).to(q.dtype)
    return torch.matmul(p, v)


def sr_attention_lse(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The forward's saved row log-sum-exp ``L = ln Σ_m exp(s·scale)``,
    f32 ``[B, h, N]``."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    return torch.logsumexp(s * q.shape[-1] ** -0.5, dim=-1)


def sr_attention_bwd_plain(q, k, v, o, lse, g, splits: int):
    """The pair's backward arithmetic: ``D = rowsum(g ∘ o)``; ``P =
    exp(s·scale − L)``, ``dS = P ∘ (g·vᵀ − D)`` in f32, rounded to the
    operands' dtype before each product; ``dq = scale·dS·k``; dk and dv
    summed over ``splits`` query splits (``split_bounds``) from split 0 in
    order, as the kernel's last pass adds its workspace. Returns ``(dq,
    dk, dv)`` in q's dtype."""
    dt, f = q.dtype, torch.float32
    scale = q.shape[-1] ** -0.5
    delta = (g.to(f) * o.to(f)).sum(-1, keepdim=True)
    p = torch.exp(torch.matmul(q.to(f), k.to(f).transpose(-1, -2)) * scale - lse[..., None])
    ds = p * (torch.matmul(g.to(f), v.to(f).transpose(-1, -2)) - delta)
    p, ds = p.to(dt).to(f), ds.to(dt).to(f)
    dq = torch.matmul(ds, k.to(f)) * scale
    dk = torch.zeros(k.shape, dtype=f, device=k.device)
    dv = torch.zeros(v.shape, dtype=f, device=v.device)
    for lo, hi in split_bounds(q.shape[-2], splits):
        dk = dk + torch.matmul(ds[..., lo:hi, :].transpose(-1, -2), q[..., lo:hi, :].to(f)) * scale
        dv = dv + torch.matmul(p[..., lo:hi, :].transpose(-1, -2), g[..., lo:hi, :].to(f))
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _fits(t: torch.Tensor) -> bool:
    """A layout the kernels read in place: the last dimension contiguous,
    every other stride and the start 16-byte aligned."""
    return (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    return t if _fits(t) else t.contiguous()


def _strides(*ts: torch.Tensor):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _takes_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the hand-written pair takes the call: bf16 operands of one
    head dimension in ``HEAD_DIMS``, some keys and queries, and B·h within
    the grid's 65 535."""
    B, h, N, d = q.shape
    return (q.dtype == k.dtype == v.dtype == torch.bfloat16 and d in HEAD_DIMS
            and k.shape[-1] == v.shape[-1] == d and N > 0 and k.shape[-2] > 0
            and B * h <= 65535)


class _SrAttention(torch.autograd.Function):
    """Kernel #10 forward, #10b backward (``csrc/sr_attention.cu``)."""

    @staticmethod
    def forward(ctx, q, k, v):
        q, k, v = (_kernel_layout(t) for t in (q, k, v))
        B, h, N, d = q.shape
        M = k.shape[2]
        # o in [B, N, h, d] memory: MiT's transpose-and-reshape to tokens is a view
        o = torch.empty((B, N, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
        lse = torch.empty((B, h, N), dtype=torch.float32, device=q.device)
        lib = _build.library()
        err = lib.seghiero_sr_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            _strides(q, k, v, o), B, h, N, M, d, forward_rows(B, h, N), q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        _build.check(lib, err, "sr_attention forward")
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        global bwd_launches
        q, k, v, o, lse = ctx.saved_tensors
        g = _kernel_layout(g)
        B, h, N, d = q.shape
        M = k.shape[2]
        splits = backward_splits(B, h, N, M)
        dq = torch.empty((B, N, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
        dk = torch.empty((B, h, M, d), dtype=k.dtype, device=k.device)
        dv = torch.empty((B, h, M, d), dtype=v.dtype, device=v.device)
        delta = torch.empty_like(lse)
        ws = torch.empty((2, splits, B * h, M, d), dtype=torch.float32, device=q.device)
        lib = _build.library()
        err = lib.seghiero_sr_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            ws.data_ptr(), _strides(q, k, v, o, g, dq, dk, dv), B, h, N, M, d, splits,
            q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
        )
        _build.check(lib, err, "sr_attention backward")
        bwd_launches += 1
        return dq, dk, dv


class _CountBackward(torch.autograd.Function):
    """Identity on the attention's output whose backward adds one to the
    module's counter ``counter``."""

    @staticmethod
    def forward(ctx, out, counter):
        ctx.counter = counter
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        globals()[ctx.counter] += 1
        return g, None


def sr_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q·kᵀ/√d)·v`` for ``q [B, h, N, d]``, ``k, v [B, h, M,
    d]``: the hand-written pair (bf16, d ∈ {32, 64}) or SDPA's flash or
    memory-efficient kernel on the card, the plain path on the CPU."""
    global launches, sdpa_launches
    if not _build.on_card(q, "sr_attention"):
        return sr_attention_plain(q, k, v)
    if _takes_kernel(q, k, v):
        out = _SrAttention.apply(q, k, v)
        launches += 1
        return out
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
        out = F.scaled_dot_product_attention(q, k, v)
    launches += 1
    sdpa_launches += 1
    if out.requires_grad:
        out = _CountBackward.apply(out, "bwd_launches")
    return out


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """The scores ``q·kᵀ`` in the operands' dtype, scaled and biased in f32,
    softmaxed in f32, rounded back, times v."""
    scores = torch.matmul(q, k.transpose(-1, -2)).to(torch.float32) * q.shape[-1] ** -0.5
    p = torch.softmax(scores + bias.to(torch.float32), dim=-1).to(q.dtype)
    return torch.matmul(p, v)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """``softmax(q·kᵀ/√d + bias)·v`` for ``q, k, v [B·nW, h, N, d]`` and
    ``bias`` broadcastable to ``[B·nW, h, N, N]``: SDPA's memory-efficient
    kernels on the card, the plain path on the CPU."""
    global window_launches
    if not _build.on_card(q, "window_attention"):
        return window_attention_plain(q, k, v, bias)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    mask = bias.to(q.dtype)
    if mask.stride(-1) != 1:  # the card's kernels read the mask's rows contiguous
        mask = mask.contiguous()
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    window_launches += 1
    if out.requires_grad:
        out = _CountBackward.apply(out, "window_bwd_launches")
    return out
