"""Kernel #1, the 3x3 depthwise convolution forward (``csrc/depthwise3x3.cu``),
bf16 NHWC: per launch the input read and the output written once, and the
9 taps; 9 multiply-adds an output. One launch a forward for each depthwise
3x3 of dilation 1 that the reference model runs (``core/geometry.py``):
the sep-ASPP head's two sep-bottleneck convolutions, 560 and 512 channels
at stride 4."""

COUNTER = ("seghiero_torch.ops.depthwise", "launches")
NAMES = ('dw3x3_fwd_kernel',)


def launches(u):
    return [{"bytes": 2 * (B * H * W * C) * 2 + 9 * C * 2, "flops": 18 * (B * H * W * C)}
            for B, H, W, C, dilation in u["depthwise"] if dilation == 1]
