"""Kernel #7, RMI's residual Gram (``y = z_la - W^T z_pr``, ``y y^T``), f32:
both maps read once; 81 + 45 multiply-adds an output pixel. One launch a
training step."""

from hbench.core import peaks

COUNTER = ("seghiero_torch.ops.rmi_gram", "residual_launches")
NAMES = ('residual_f32_kernel', 'gram_finish_kernel')


def launches(u):
    B, (H, W) = u["batch"], u["hw"]
    maps = B * sum(u["levels"])
    return [{"bytes": 2 * maps * H * W * 4, "flops": 252 * maps * (H - 2) * (W - 2),
             "flops_per_s": peaks.F32_FLOPS}]
