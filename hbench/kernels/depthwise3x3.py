"""Kernel #1, the decode head's 3x3 depthwise convolution forward
(``csrc/depthwise3x3.cu``), bf16 NHWC: per launch the input read and the
output written once, and the 9 taps; 9 multiply-adds an output. Two
launches a forward: the sep-bottleneck's 560 and 512 channels at stride 4."""

COUNTER = ("seghiero_torch.ops.depthwise", "launches")
NAMES = ('dw3x3_fwd_kernel',)


def launches(u):
    B, (h, w) = u["batch"], u["hw4"]
    out = []
    for C in (u["aspp_channels"] + u["c1_channels"], u["aspp_channels"]):
        n = B * h * w * C
        out.append({"bytes": 2 * n * 2 + 9 * C * 2, "flops": 18 * n})
    return out
