"""Kernel #2, the depthwise convolution's weight gradient
(``csrc/depthwise3x3_wgrad.cu``): the input and the output gradient read
(bf16), the f32 taps' gradient written; one launch a training step for
each depthwise 3x3 of dilation 1 that the reference model runs."""

COUNTER = ("seghiero_torch.ops.depthwise", "wgrad_launches")
NAMES = ('dw3x3_wgrad_partial_kernel', 'dw3x3_wgrad_finish_kernel')


def launches(u):
    return [{"bytes": 2 * (B * H * W * C) * 2 + 9 * C * 4, "flops": 18 * (B * H * W * C)}
            for B, H, W, C, dilation in u["depthwise"] if dilation == 1]
