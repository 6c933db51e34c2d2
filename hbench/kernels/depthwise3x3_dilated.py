"""Kernel #9, the dilated 3x3 depthwise convolution forward of the ASPP's
three separable branches (``csrc/depthwise3x3_dilated.cu``), bf16 NHWC, run
where autograd needs no backward (inference): per launch the input read and
the output written once (the centre tap reads every input element), and the
9 taps; 9 multiply-adds an output. Three launches a forward, at dilations
12 / 24 / 36 on the backbone's 2048 channels at output stride 8."""

COUNTER = ("seghiero_torch.ops.depthwise", "dilated_launches")
NAMES = ("dw3x3_dilated_fwd_kernel",)

BACKBONE_CHANNELS = 2048
BRANCHES = 3


def launches(u):
    B, (h4, w4) = u["batch"], u["hw4"]
    h8, w8 = (h4 - 1) // 2 + 1, (w4 - 1) // 2 + 1  # the 3x3 stride-2 conv of stage 2
    C = BACKBONE_CHANNELS
    n = B * h8 * w8 * C
    return [{"bytes": 2 * n * 2 + 9 * C * 2, "flops": 18 * n} for _ in range(BRANCHES)]
