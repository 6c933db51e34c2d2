"""3×3 depthwise convolution, stride 1, dilation 1, "same" zero padding —
the port of ``seghiero_tpu/ops/pallas/depthwise.py`` (forward).

``depthwise3x3`` launches the CUDA kernel ``csrc/depthwise3x3.cu`` for a
tensor on the card and runs ``depthwise3x3_plain`` for a tensor on the
CPU; any other device raises. The public layout is the JAX one: x NHWC
``[B, H, W, C]``, taps ``k9 [9, C]`` in (dy, dx) row-major order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from seghiero_torch.ops import _build

# kernel launches made by depthwise3x3 in this process (set to 0 to count a run)
launches = 0


def depthwise3x3_plain(x: torch.Tensor, k9: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: 9 shifted multiply-adds
    over a zero-padded f32 copy, summed in (dy, dx) row-major order from 0,
    rounded once to ``x.dtype``."""
    B, H, W, C = x.shape
    xp = F.pad(x.to(torch.float32), (0, 0, 1, 1, 1, 1))
    k = k9.to(torch.float32)
    acc = torch.zeros((B, H, W, C), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc = acc + xp[:, dy : dy + H, dx : dx + W, :] * k[dy * 3 + dx]
    return acc.to(x.dtype)


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


def depthwise3x3(x: torch.Tensor, k9: torch.Tensor) -> torch.Tensor:
    """x NHWC ``[B, H, W, C]`` (f32 or bf16), k9 ``[9, C]`` of the same
    dtype → ``[B, H, W, C]`` of x's dtype.

    On the card x must be contiguous in NHWC — which a channels_last NCHW
    activation permuted by ``.permute(0, 2, 3, 1)`` already is. The
    wrapper raises instead of copying a tensor that is not."""
    if x.device.type == "cpu":
        return depthwise3x3_plain(x, k9)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise3x3 runs on cuda or cpu tensors, got {x.device}")
    if x.ndim != 4:
        raise ValueError(f"x must be NHWC [B, H, W, C], got shape {tuple(x.shape)}")
    B, H, W, C = x.shape
    if tuple(k9.shape) != (9, C):
        raise ValueError(f"k9 must be [9, {C}], got {tuple(k9.shape)}")
    if k9.dtype != x.dtype or k9.device != x.device:
        raise ValueError(
            f"k9 must match x in dtype and device ({x.dtype}, {x.device}), "
            f"got ({k9.dtype}, {k9.device})"
        )
    if not x.is_contiguous() or not k9.is_contiguous():
        raise ValueError(
            "depthwise3x3 needs NHWC-contiguous x and contiguous k9 (pass a "
            "channels_last NCHW activation permuted to NHWC); refusing to copy"
        )
    code = _build.dtype_code(x.dtype)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    vec = _vector_width(C, x.element_size(), x, k9, out)
    lib = _build.library()
    err = lib.seghiero_dw3x3_fwd(
        x.data_ptr(), k9.data_ptr(), out.data_ptr(), B, H, W, C, code, vec,
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "depthwise3x3")
    global launches
    launches += 1
    return out
