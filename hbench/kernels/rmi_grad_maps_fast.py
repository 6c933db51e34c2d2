"""Kernel #8, RMI's gradient maps (a folded 5x5 correlation), f32: both maps
read and the probability map's gradient written once; 50 multiply-adds a
pixel. One launch a training step.

The bf16-view variant (``rmi_precision: fast``; products on bf16
operands at the tensor-core rate)."""

from hbench.core import peaks

COUNTER = ("seghiero_torch.ops.rmi_gram", "grad_fast_launches")
NAMES = ('grad_maps_kernel',)


def launches(u):
    B, (H, W) = u["batch"], u["hw"]
    maps = B * sum(u["levels"])
    return [{"bytes": 3 * maps * H * W * 4, "flops": 100 * maps * H * W,
             "flops_per_s": peaks.BF16_FLOPS}]
