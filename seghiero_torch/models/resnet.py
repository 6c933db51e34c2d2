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


def batch_norm(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)


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
