"""Kernel #9, the dilated 3x3 depthwise convolution forward
(``csrc/depthwise3x3_dilated.cu``), bf16 NHWC, run where autograd needs no
backward (inference): per launch the input read and the output written
once (the centre tap reads every input element), and the 9 taps; 9
multiply-adds an output. One launch a forward for each depthwise 3x3 of
dilation above 1 that the reference model runs: the ASPP's three separable
branches, dilations 12 / 24 / 36 on the backbone's 2048 channels at output
stride 8."""

COUNTER = ("seghiero_torch.ops.depthwise", "dilated_launches")
NAMES = ("dw3x3_dilated_fwd_kernel",)


def launches(u):
    return [{"bytes": 2 * (B * H * W * C) * 2 + 9 * C * 2, "flops": 18 * (B * H * W * C)}
            for B, H, W, C, dilation in u["depthwise"] if dilation > 1]
