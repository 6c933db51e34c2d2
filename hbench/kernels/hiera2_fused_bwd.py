"""Kernel #5, the fused 2-level loss backward: the logits and labels read,
the logits' gradient written; 4n + 1 special-function results a valid
pixel and level of n classes. One launch a training step."""

COUNTER = ("seghiero_torch.ops.hiera2_fused", "bwd_launches")
NAMES = ('hiera2_bwd_kernel',)


def launches(u):
    B, (h, w), (H, W) = u["batch"], u["hw4"], u["hw"]
    nf, nc = u["levels"][:2]
    logits = B * (nf + nc) * h * w * 4
    labels = 2 * B * H * W * 4
    return [{"bytes": 2 * logits + labels, "mufu": u["valid"] * (4 * nf + 1 + 4 * nc + 1)}]
