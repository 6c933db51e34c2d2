"""Kernel #3, the 4x bilinear upsample and per-level argmax of the serving
and inference decode (``csrc/upsample_argmax.cu``): the low-res logits
read once, every level's int32 mask written at 4x the size. One launch a
batch."""

COUNTER = ("seghiero_torch.ops.upsample_argmax", "launches")
NAMES = ('upsample_argmax_kernel',)


def launches(u):
    B, (h, w) = u["batch"], u["hw4"]
    C, L = sum(u["levels"]), len(u["levels"])
    return [{"bytes": B * C * h * w * u["logits_bytes"] + B * L * 16 * h * w * 4,
             "flops": B * C * 16 * h * w * 4}]
