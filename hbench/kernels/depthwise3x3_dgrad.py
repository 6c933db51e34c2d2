"""Kernel #1b, the depthwise convolution's input gradient (the same
kernel with reversed taps): the output gradient read, the input gradient
written, the taps; two launches a training step."""

COUNTER = ("seghiero_torch.ops.depthwise", "dgrad_launches")
NAMES = ('dw3x3_fwd_kernel',)


def launches(u):
    B, (h, w) = u["batch"], u["hw4"]
    out = []
    for C in (u["aspp_channels"] + u["c1_channels"], u["aspp_channels"]):
        n = B * h * w * C
        out.append({"bytes": 2 * n * 2 + 9 * C * 2, "flops": 18 * n})
    return out
