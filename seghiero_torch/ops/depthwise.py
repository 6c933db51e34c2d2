"""3×3 depthwise convolution, stride 1, dilation 1, "same" zero padding,
with its gradient — the port of ``seghiero_tpu/ops/pallas/depthwise.py``
(``depthwise3x3`` and its ``custom_vjp``, :265-305).

``depthwise3x3`` is a ``torch.autograd.Function``:

* forward: ``csrc/depthwise3x3.cu`` (kernel #1);
* input gradient: the same forward kernel run on the cotangent with the
  taps reversed, ``k9.flip(0)`` (kernel #1b — exactly the JAX ``_dw_bwd``);
* weight gradient: ``csrc/depthwise3x3_wgrad.cu`` (kernel #2), returned in
  ``k9``'s dtype.

``depthwise3x3_dilated_forward`` is the forward alone at a dilation d
(``csrc/depthwise3x3_dilated.cu``, kernel #9): the ASPP's separable
branches where no gradient is asked of them. The JAX package has no
Pallas kernel for it (``seghiero_tpu/models/heads.py:101-111``).

Each wrapper launches its kernel for a tensor on the card and runs its
plain PyTorch version for a tensor on the CPU; any other device raises.
The public layout is the JAX one: x NHWC ``[B, H, W, C]``, taps
``k9 [9, C]`` in (dy, dx) row-major order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from seghiero_torch.ops import _build

# kernel launches in this process (set to 0 to count a run): the forward,
# the input gradient (#1b, the forward kernel with reversed taps) and the
# weight gradient (#2), and the dilated forward (#9)
launches = 0
dgrad_launches = 0
wgrad_launches = 0
dilated_launches = 0
# cotangents the backward had to copy to NHWC-contiguous before its kernels
backward_copies = 0
COUNTERS = ("launches", "dgrad_launches", "wgrad_launches", "dilated_launches",
            "backward_copies")


def depthwise3x3_dilated_plain(x: torch.Tensor, k9: torch.Tensor, d: int) -> torch.Tensor:
    """The kernels' arithmetic in plain PyTorch at dilation d: 9 shifted
    multiply-adds over an f32 copy zero-padded by d, summed in (dy, dx)
    row-major order from 0, rounded once to ``x.dtype``."""
    B, H, W, C = x.shape
    xp = F.pad(x.to(torch.float32), (0, 0, d, d, d, d))
    k = k9.to(torch.float32)
    acc = torch.zeros((B, H, W, C), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc = acc + xp[:, dy * d : dy * d + H, dx * d : dx * d + W, :] * k[dy * 3 + dx]
    return acc.to(x.dtype)


def depthwise3x3_plain(x: torch.Tensor, k9: torch.Tensor) -> torch.Tensor:
    """Kernel #1's arithmetic: the plain version at dilation 1."""
    return depthwise3x3_dilated_plain(x, k9, 1)


def depthwise3x3_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dk[dy·3+dx, c] = Σ_{b,h,w} x[b, h+dy−1, w+dx−1, c]·g[b, h, w, c]``
    in f32 (zero padding), as ``[9, C]`` f32. Summed by ``torch.sum``,
    not in the kernel's order (which follows its launch geometry), so the
    kernel is held to it within ``1e-5 · Σ|x·g|`` per entry."""
    B, H, W, C = x.shape
    xp = F.pad(x.to(torch.float32), (0, 0, 1, 1, 1, 1))
    gf = g.to(torch.float32)
    return torch.stack([
        (xp[:, dy : dy + H, dx : dx + W, :] * gf).sum(dim=(0, 1, 2))
        for dy in range(3) for dx in range(3)
    ])


def _vector_width(C: int, itemsize: int, *tensors: torch.Tensor) -> int:
    """Channels per thread: the widest 16-byte-or-less vector that divides C
    and keeps every pointer aligned."""
    for vec in (8, 4, 2, 1):
        nbytes = vec * itemsize
        if nbytes > 16 or C % vec:
            continue
        if all(t.data_ptr() % nbytes == 0 for t in tensors):
            return vec
    return 1


def _check_nhwc(x: torch.Tensor, other: torch.Tensor, other_shape, what: str) -> None:
    if x.ndim != 4:
        raise ValueError(f"{what}: x must be NHWC [B, H, W, C], got shape {tuple(x.shape)}")
    if tuple(other.shape) != tuple(other_shape):
        raise ValueError(f"{what}: expected {tuple(other_shape)}, got {tuple(other.shape)}")
    if other.dtype != x.dtype or other.device != x.device:
        raise ValueError(
            f"{what}: operands must match x in dtype and device ({x.dtype}, {x.device}), "
            f"got ({other.dtype}, {other.device})"
        )
    if not x.is_contiguous() or not other.is_contiguous():
        raise ValueError(
            f"{what} needs NHWC-contiguous operands (pass a channels_last NCHW "
            "activation permuted to NHWC); refusing to copy"
        )


def _launch_forward(x: torch.Tensor, k9: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
    _check_nhwc(x, k9, (9, C), "depthwise3x3")
    code = _build.dtype_code(x.dtype)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    vec = _vector_width(C, x.element_size(), x, k9, out)
    lib = _build.library()
    err = lib.seghiero_dw3x3_fwd(
        x.data_ptr(), k9.data_ptr(), out.data_ptr(), B, H, W, C, code, vec,
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "depthwise3x3")
    return out


def depthwise3x3_forward(x: torch.Tensor, k9: torch.Tensor) -> torch.Tensor:
    """The forward alone (no autograd): kernel #1 on the card, the plain
    version on the CPU. On the card x must be contiguous in NHWC — which a
    channels_last NCHW activation permuted by ``.permute(0, 2, 3, 1)``
    already is; the wrapper raises instead of copying a tensor that is not."""
    if not _build.on_card(x, "depthwise3x3"):
        return depthwise3x3_plain(x, k9)
    out = _launch_forward(x, k9)
    global launches
    launches += 1
    return out


def depthwise3x3_dilated_forward(x: torch.Tensor, k9: torch.Tensor, d: int) -> torch.Tensor:
    """The forward at dilation ``d`` ≥ 1 ("same" zero padding d), no
    autograd: kernel #9 on the card, the plain version on the CPU. x as
    for ``depthwise3x3_forward`` (NHWC-contiguous on the card, never
    copied)."""
    if d < 1:
        raise ValueError(f"depthwise3x3_dilated: dilation must be ≥ 1, got {d}")
    if not _build.on_card(x, "depthwise3x3_dilated"):
        return depthwise3x3_dilated_plain(x, k9, d)
    B, H, W, C = x.shape
    _check_nhwc(x, k9, (9, C), "depthwise3x3_dilated")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    vec = _vector_width(C, x.element_size(), x, k9, out)
    lib = _build.library()
    err = lib.seghiero_dw3x3_dil_fwd(
        x.data_ptr(), k9.data_ptr(), out.data_ptr(), B, H, W, C, d,
        _build.dtype_code(x.dtype), vec, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "depthwise3x3_dilated")
    global dilated_launches
    dilated_launches += 1
    return out


def depthwise3x3_dgrad(g: torch.Tensor, k9: torch.Tensor) -> torch.Tensor:
    """Input gradient: the forward with the taps reversed (a stride-1
    "same" correlation's transpose), in g's dtype (kernel #1b)."""
    k_flip = k9.flip(0).contiguous()  # reversing (dy·3+dx) flips both axes
    if not _build.on_card(g, "depthwise3x3_dgrad"):
        return depthwise3x3_plain(g, k_flip)
    out = _launch_forward(g, k_flip)
    global dgrad_launches
    dgrad_launches += 1
    return out


def wgrad_partials(B: int, H: int, W: int) -> int:
    """Rows of the kernel's partial-sum scratch for x of shape
    ``[B, H, W, ·]``, as the kernel's own partition gives them."""
    P = _build.library().seghiero_dw3x3_wgrad_partials(B, H, W)
    if P < 0:
        raise ValueError(f"depthwise3x3_wgrad: shape {(B, H, W)} is past the kernel's grid")
    return P


def depthwise3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient ``[9, C]`` f32 from x and the cotangent g (both NHWC
    ``[B, H, W, C]``, f32 or bf16): kernel #2 on the card, the plain
    version on the CPU."""
    if not _build.on_card(x, "depthwise3x3_wgrad"):
        return depthwise3x3_wgrad_plain(x, g)
    _check_nhwc(x, g, x.shape, "depthwise3x3_wgrad")
    B, H, W, C = x.shape
    code = _build.dtype_code(x.dtype)
    P = wgrad_partials(B, H, W)
    partial = torch.empty((P, 9, C), dtype=torch.float32, device=x.device)
    dk = torch.empty((9, C), dtype=torch.float32, device=x.device)
    vec = _vector_width(C, x.element_size(), x, g)
    lib = _build.library()
    err = lib.seghiero_dw3x3_wgrad(
        x.data_ptr(), g.data_ptr(), partial.data_ptr(), dk.data_ptr(), B, H, W, C,
        code, vec, P, x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "depthwise3x3_wgrad")
    global wgrad_launches
    wgrad_launches += 1
    return dk


class _Depthwise3x3(torch.autograd.Function):
    """The ``custom_vjp`` of the JAX package: residuals x and k9; the
    backward runs the input-gradient and weight-gradient kernels."""

    @staticmethod
    def forward(ctx, x, k9):
        ctx.save_for_backward(x, k9)
        return depthwise3x3_forward(x, k9)

    @staticmethod
    def backward(ctx, g):
        x, k9 = ctx.saved_tensors
        if g.device.type == "cuda" and not g.is_contiguous():
            # the cotangent of the head's NCHW view may arrive in another
            # layout; one counted copy here, never one in the forward
            global backward_copies
            backward_copies += 1
            g = g.contiguous()
        dx = depthwise3x3_dgrad(g, k9) if ctx.needs_input_grad[0] else None
        dk = depthwise3x3_wgrad(x, g).to(k9.dtype) if ctx.needs_input_grad[1] else None
        return dx, dk


def depthwise3x3(x: torch.Tensor, k9: torch.Tensor) -> torch.Tensor:
    """x NHWC ``[B, H, W, C]`` (f32 or bf16), k9 ``[9, C]`` of the same
    dtype → ``[B, H, W, C]`` of x's dtype, differentiable in both (the
    backward through kernels #1b and #2 on the card)."""
    _build.on_card(x, "depthwise3x3")
    return _Depthwise3x3.apply(x, k9)
