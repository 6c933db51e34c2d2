"""Kernel #1b, the depthwise convolution's input gradient (the same
kernel with reversed taps): the output gradient read, the input gradient
written, the taps; one launch a training step for each depthwise 3x3 of
dilation 1 that the reference model runs."""

COUNTER = ("seghiero_torch.ops.depthwise", "dgrad_launches")
NAMES = ('dw3x3_fwd_kernel',)


def launches(u):
    return [{"bytes": 2 * (B * H * W * C) * 2 + 9 * C * 2, "flops": 18 * (B * H * W * C)}
            for B, H, W, C, dilation in u["depthwise"] if dilation == 1]
