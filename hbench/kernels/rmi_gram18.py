"""Kernel #6, RMI's 18x18 Gram of the one-hot and probability maps' 3x3
views (``csrc/rmi_gram.cu``, f32): both maps read once; 51 multiply-adds
an output pixel (its lag sums). One launch a training step."""

from hbench.core import peaks

COUNTER = ("seghiero_torch.ops.rmi_gram", "gram18_launches")
NAMES = ('gram18_kernel', 'gram18_finish_kernel')


def launches(u):
    B, (H, W) = u["batch"], u["hw"]
    maps = B * sum(u["levels"])
    return [{"bytes": 2 * maps * H * W * 4, "flops": 102 * maps * (H - 2) * (W - 2),
             "flops_per_s": peaks.F32_FLOPS}]
