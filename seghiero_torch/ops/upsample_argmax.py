"""Fused exact-4× bilinear upsample + per-level channel argmax — the port of
``seghiero_tpu/ops/pallas/upsample_argmax.py``.

``upsample_argmax`` launches the CUDA kernel ``csrc/upsample_argmax.cu``
for a tensor on the card and runs ``upsample_argmax_plain`` for a tensor
on the CPU; any other device raises. The public layout is the JAX one:
C-major logits ``[B, C, h, w]`` in, one int32 ``[B, 4h, 4w]`` mask per
level out.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from seghiero_torch.ops import _build

SCALE = 4
MAX_LEVELS = 3

# phase → (row shift of the low tap in the edge-padded array, weight_lo,
# weight_hi), from src = (dst + 0.5)/4 − 0.5 (the TPU kernel's _PHASE)
PHASE = (
    (0, 0.375, 0.625),
    (0, 0.125, 0.875),
    (1, 0.875, 0.125),
    (1, 0.625, 0.375),
)

# kernel launches made by upsample_argmax in this process (set to 0 to count a run)
launches = 0


def upsample_argmax_plain(
    logits: torch.Tensor, level_slices: Sequence[Tuple[int, int]]
) -> Tuple[torch.Tensor, ...]:
    """The kernel's arithmetic in plain PyTorch: edge pad, 9 shifted views,
    the 16-phase blend ``ay·(ax·t00 + bx·t01) + by·(ax·t10 + bx·t11)`` in
    f32 in that order, then a first-strict-maximum argmax per level."""
    B, C, h, w = logits.shape
    lp = F.pad(logits.to(torch.float32), (1, 1, 1, 1), mode="replicate")
    views = [lp[:, :, r : r + h, c : c + w] for r in range(3) for c in range(3)]
    outs = [
        torch.empty((B, h, SCALE, w, SCALE), dtype=torch.int32, device=logits.device)
        for _ in level_slices
    ]
    for py, (ro, ay, by) in enumerate(PHASE):
        for px, (co, ax, bx) in enumerate(PHASE):
            t00, t01 = views[ro * 3 + co], views[ro * 3 + co + 1]
            t10, t11 = views[(ro + 1) * 3 + co], views[(ro + 1) * 3 + co + 1]
            blend = ay * (ax * t00 + bx * t01) + by * (ax * t10 + bx * t11)
            for out, (lo, hi) in zip(outs, level_slices):
                best = blend[:, lo]
                idx = torch.zeros_like(best, dtype=torch.int32)
                for c in range(lo + 1, hi):
                    take = blend[:, c] > best  # strict: the first maximum wins
                    idx = torch.where(take, c - lo, idx)
                    best = torch.maximum(best, blend[:, c])
                out[:, :, py, :, px] = idx
    return tuple(o.reshape(B, SCALE * h, SCALE * w) for o in outs)


def upsample_argmax(
    logits: torch.Tensor, level_slices: Sequence[Tuple[int, int]]
) -> Tuple[torch.Tensor, ...]:
    """Per-level ``argmax(upsample4x(logits)[:, lo:hi], dim=1)`` as int32
    ``[B, 4h, 4w]`` masks, without materializing the upsampled logits.
    ``logits`` is C-major ``[B, C, h, w]``, f32 or bf16; on the card it
    must be contiguous (the wrapper raises instead of copying)."""
    slices = [(int(a), int(b)) for a, b in level_slices]
    if logits.device.type == "cpu":
        return upsample_argmax_plain(logits, slices)
    if logits.device.type != "cuda":
        raise ValueError(
            f"upsample_argmax runs on cuda or cpu tensors, got {logits.device}"
        )
    if logits.ndim != 4:
        raise ValueError(f"logits must be [B, C, h, w], got {tuple(logits.shape)}")
    B, C, h, w = logits.shape
    if not 1 <= len(slices) <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} level slices, got {len(slices)}")
    if any(not 0 <= a < b <= C for a, b in slices):
        raise ValueError(f"level slices {slices} must lie in [0, {C})")
    if not logits.is_contiguous():
        raise ValueError(
            "upsample_argmax needs contiguous C-major logits; refusing to copy"
        )
    code = _build.dtype_code(logits.dtype)
    outs = [
        torch.empty((B, SCALE * h, SCALE * w), dtype=torch.int32, device=logits.device)
        for _ in slices
    ]
    bounds = [v for s in slices for v in s] + [0, 0] * (MAX_LEVELS - len(slices))
    ptrs = [o.data_ptr() for o in outs] + [None] * (MAX_LEVELS - len(outs))
    lib = _build.library()
    err = lib.seghiero_upsample_argmax(
        logits.data_ptr(), B, C, h, w, code, len(slices), *bounds, *ptrs,
        logits.device.index, torch.cuda.current_stream(logits.device).cuda_stream,
    )
    _build.check(lib, err, "upsample_argmax")
    global launches
    launches += 1
    return tuple(outs)
