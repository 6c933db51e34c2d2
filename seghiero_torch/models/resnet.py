"""ResNet backbone (NCHW) — the port of ``seghiero_tpu/models/resnet.py``.

torchvision v1.5 structure (stride on the bottleneck's 3×3), depths
18/34/50/101/152, output stride 32/16/8 by dilating the last stages
(torchvision ``replace_stride_with_dilation`` semantics), torch-symmetric
padding, BatchNorm eps 1e-5. Parameter names follow the reference
checkpoint (``stem_conv``, ``stem_bn``, ``layerN.b.convK``,
``layerN.b.downsample.{0,1}``). Only the plain 7×7 stem exists here; the
TPU's space-to-depth stem is rejected at config load.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

STAGE_BLOCKS = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
BOTTLENECK_DEPTHS = (50, 101, 152)


def conv(cin: int, cout: int, kernel: int, stride: int = 1, dilation: int = 1) -> nn.Conv2d:
    """Bias-free conv with torch-symmetric 'same' padding."""
    pad = dilation * (kernel - 1) // 2
    return nn.Conv2d(
        cin, cout, kernel, stride=stride, padding=pad, dilation=dilation, bias=False
    )


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running variance follows flax: updated with
    the BIASED batch variance (torch uses the unbiased one). Train mode
    keeps cuDNN's fused kernel and corrects afterwards, in place:
    torch left ``rv = (1−m)·rv_old + m·var·n/(n−1)``; the flax update is
    ``rv·(1 − 1/n) + rv_old·(1−m)/n`` with ``n`` = elements per channel.

    One value a channel in train mode (UperNet's 1×1 pool on a batch of one
    image), which PyTorch refuses, follows flax too: the value is its own
    mean at variance 0, so the output is the shift, neither the input nor
    the scale gets a gradient, and the running statistics move toward the
    value and toward 0."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats and self.momentum is not None):
            return super().forward(x)
        n = x.numel() // x.shape[1]
        if n == 1:
            return self._one_value(x)
        rv_old = self.running_var.clone()
        out = super().forward(x)
        # through .data: the BN backward holds running_var and checks its
        # version counter, though training-mode gradients never read it
        self.running_var.data.mul_(1.0 - 1.0 / n).add_(rv_old, alpha=(1.0 - self.momentum) / n)
        return out

    def _one_value(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        shape = (1, -1) + (1,) * (x.ndim - 2)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(xf.reshape(-1), alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum)
            self.num_batches_tracked.add_(1)
        xhat = (xf - xf) * self.eps ** -0.5
        return (xhat * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)


def batch_norm(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv1 = conv(cin, width, 3, stride, dilation)
        self.bn1 = batch_norm(width)
        self.conv2 = conv(width, width, 3, dilation=dilation)
        self.bn2 = batch_norm(width)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != width:
            self.downsample = nn.Sequential(conv(cin, width, 1, stride), batch_norm(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv1 = conv(cin, width, 1)
        self.bn1 = batch_norm(width)
        self.conv2 = conv(width, width, 3, stride, dilation)
        self.bn2 = batch_norm(width)
        self.conv3 = conv(width, width * 4, 1)
        self.bn3 = batch_norm(width * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != width * 4:
            self.downsample = nn.Sequential(
                conv(cin, width * 4, 1, stride), batch_norm(width * 4)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + identity)


class ResNetBackbone(nn.Module):
    """images NCHW → (C1, C2, C3, C4) at strides 4/8/16/32 (or the dilated
    equivalents for output_stride 16 and 8)."""

    def __init__(self, depth: int = 101, output_stride: int = 32):
        super().__init__()
        if depth not in STAGE_BLOCKS:
            raise ValueError(f"depth must be one of {sorted(STAGE_BLOCKS)}")
        if output_stride not in (8, 16, 32):
            raise ValueError("output_stride must be 8, 16 or 32")
        block_cls = Bottleneck if depth in BOTTLENECK_DEPTHS else BasicBlock
        self.widths = self.stage_channels(depth)
        dilate_stage = {8: (2, 3), 16: (3,), 32: ()}[output_stride]
        self.stem_conv = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.stem_bn = batch_norm(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        cin, dilation = 64, 1
        for stage, (width, n_blocks) in enumerate(zip((64, 128, 256, 512), STAGE_BLOCKS[depth])):
            stride = 1 if stage == 0 else 2
            prev_dilation = dilation
            if stage in dilate_stage:
                dilation *= stride
                stride = 1
            blocks = []
            for b in range(n_blocks):
                # torchvision: the stage's first block keeps the pre-doubling
                # dilation, the rest use the doubled one
                blocks.append(block_cls(
                    cin, width, stride if b == 0 else 1,
                    prev_dilation if b == 0 else dilation,
                ))
                cin = width * block_cls.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.maxpool(self.relu(self.stem_bn(self.stem_conv(x))))
        feats = []
        for name in ("layer1", "layer2", "layer3", "layer4"):
            x = getattr(self, name)(x)
            feats.append(x)
        return tuple(feats)

    @staticmethod
    def stage_channels(depth: int) -> Tuple[int, int, int, int]:
        if depth in BOTTLENECK_DEPTHS:
            return (256, 512, 1024, 2048)
        return (64, 128, 256, 512)
