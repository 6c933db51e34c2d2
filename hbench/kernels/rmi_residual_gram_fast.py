"""Kernel #7, RMI's residual Gram (``y = z_la - W^T z_pr``, ``y y^T``), f32:
both maps read once; 81 + 45 multiply-adds an output pixel. One launch a
training step.

The bf16-view variant (``rmi_precision: fast``; products on bf16
operands at the tensor-core rate)."""

from hbench.core import peaks

COUNTER = ("seghiero_torch.ops.rmi_gram", "residual_fast_launches")
NAMES = ('residual_mma_kernel', 'gram_finish_kernel')


def launches(u):
    B, (H, W) = u["batch"], u["hw"]
    maps = B * sum(u["levels"])
    return [{"bytes": 2 * maps * H * W * 4, "flops": 252 * maps * (H - 2) * (W - 2),
             "flops_per_s": peaks.BF16_FLOPS}]
