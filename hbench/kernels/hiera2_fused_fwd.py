"""Kernel #4, the fused 2-level loss forward (``csrc/hiera2_fused.cu``):
the f32 low-res logits and both int32 label maps read once; its
special-function results are 3n + 1 a valid label pixel and level of n
classes (the 4x upsample, the hierarchy BCE and both CEs). One launch a
training step."""

COUNTER = ("seghiero_torch.ops.hiera2_fused", "fwd_launches")
NAMES = ('hiera2_fwd_kernel', 'hiera2_finish_kernel')


def launches(u):
    B, (h, w), (H, W) = u["batch"], u["hw4"], u["hw"]
    nf, nc = u["levels"][:2]
    logits = B * (nf + nc) * h * w * 4
    labels = 2 * B * H * W * 4
    return [{"bytes": logits + labels, "mufu": u["valid"] * (3 * nf + 1 + 3 * nc + 1)}]
