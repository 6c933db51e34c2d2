"""Kernel #2, the depthwise convolution's weight gradient
(``csrc/depthwise3x3_wgrad.cu``): the input and the output gradient read
(bf16), the f32 taps' gradient written; two launches a training step."""

COUNTER = ("seghiero_torch.ops.depthwise", "wgrad_launches")
NAMES = ('dw3x3_wgrad_partial_kernel', 'dw3x3_wgrad_finish_kernel')


def launches(u):
    B, (h, w) = u["batch"], u["hw4"]
    out = []
    for C in (u["aspp_channels"] + u["c1_channels"], u["aspp_channels"]):
        n = B * h * w * C
        out.append({"bytes": 2 * n * 2 + 9 * C * 4, "flops": 18 * n})
    return out
