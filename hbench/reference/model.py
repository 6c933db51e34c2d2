"""The plain float32 reference of the hierarchical segmenter: a torchvision
v1.5 ResNet (output stride 32, 16 or 8: the last stages dilated as
torchvision's ``replace_stride_with_dilation`` does), the DeepLabV3+-style
depthwise-separable
ASPP head with its contrastive projection, and the aux head, written in
plain ``torch.nn.functional`` calls. It imports nothing of the program.

Module and parameter names follow the reference SegHiero checkpoint
layout (``backbone.*``, ``aspp_head.*``, ``aux_head.*``), so one state
dict made by ``hbench.core.weights`` loads into this model and into the
program's, and a mismatch of names or shapes fails loudly.

``lowp.enabled`` switches every convolution to fp8 operands (see
``hbench/reference/lowp.py``): the correctness control.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hbench.reference import lowp

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
BN_EPS = 1e-5
# the last BatchNorm of each residual branch: its scales are drawn at a
# tenth (``hbench.core.weights``)
RESIDUAL_LAST = (".bn3.",)


def conv(x: torch.Tensor, w: torch.Tensor, b=None, stride=1, padding=0, dilation=1,
         groups=1) -> torch.Tensor:
    """``F.conv2d``, with fp8 operands under the control."""
    if lowp.enabled():
        x, w = lowp.q8(x), lowp.q8(w)
    return F.conv2d(x, w, b, stride, padding, dilation, groups)


class Conv(nn.Module):
    """A convolution's parameters (``weight`` ``[out, in/groups, k, k]``)."""

    def __init__(self, cin: int, cout: int, k: int, groups: int = 1, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x, stride=1, dilation=1, groups=1):
        k = self.weight.shape[-1]
        return conv(x, self.weight, self.bias, stride, dilation * (k - 1) // 2, dilation, groups)


class BN(nn.Module):
    """Batch normalization: batch statistics in train mode, the running
    ones in eval mode (the running statistics are inputs here, never
    compared)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))
        self.momentum = 0.1

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            self.training, self.momentum, BN_EPS)


def _cbr(cin, cout):
    return nn.Sequential(Conv(cin, cout, 1), BN(cout), nn.ReLU())


def _run_cbr(seq, x):
    return F.relu(seq[1](seq[0](x)))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, dilation: int = 1):
        super().__init__()
        self.conv1, self.bn1 = Conv(cin, width, 1), BN(width)
        self.conv2, self.bn2 = Conv(width, width, 3), BN(width)
        self.conv3, self.bn3 = Conv(width, width * 4, 1), BN(width * 4)
        self.stride, self.dilation = stride, dilation
        self.downsample = None
        if stride != 1 or cin != width * 4:
            self.downsample = nn.Sequential(Conv(cin, width * 4, 1), BN(width * 4))

    def forward(self, x):
        idt = x if self.downsample is None else \
            self.downsample[1](self.downsample[0](x, stride=self.stride))
        y = F.relu(self.bn1(self.conv1(x)))
        # v1.5: stride on the 3x3
        y = F.relu(self.bn2(self.conv2(y, stride=self.stride, dilation=self.dilation)))
        return F.relu(self.bn3(self.conv3(y)) + idt)


class Backbone(nn.Module):
    """Stages 3 and 4 (output stride 8) or 4 (16) trade their stride for a
    doubled dilation; a dilated stage's first block keeps the dilation
    before the doubling."""

    def __init__(self, depth: int, output_stride: int = 32):
        super().__init__()
        self.stem_conv, self.stem_bn = Conv(3, 64, 7), BN(64)
        dilated = {8: (2, 3), 16: (3,), 32: ()}[output_stride]
        cin, dilation = 64, 1
        for i, (width, n) in enumerate(zip((64, 128, 256, 512), STAGE_BLOCKS[depth])):
            stride, first = (1 if i == 0 else 2), dilation
            if i in dilated:
                stride, dilation = 1, dilation * 2
            blocks = [Bottleneck(cin if b == 0 else width * 4, width, stride if b == 0 else 1,
                                 first if b == 0 else dilation) for b in range(n)]
            cin = width * 4
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        x = F.relu(self.stem_bn(self.stem_conv(x, stride=2)))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
            feats.append(x)
        return feats


class SepConv(nn.Module):
    """3x3 depthwise (dilated) → BN → ReLU → 1x1 → BN → ReLU."""

    def __init__(self, cin: int, cout: int, dilation: int = 1):
        super().__init__()
        self.depthwise, self.bn_dw = Conv(cin, cin, 3, groups=cin), BN(cin)
        self.pointwise, self.bn_pw = Conv(cin, cout, 1), BN(cout)
        self.dilation = dilation

    def forward(self, x):
        y = F.relu(self.bn_dw(self.depthwise(x, dilation=self.dilation, groups=x.shape[1])))
        return F.relu(self.bn_pw(self.pointwise(y)))


class ASPP(nn.Module):
    def __init__(self, cin: int, ch: int, dilations: Sequence[int]):
        super().__init__()
        self.image_pool_conv = _cbr(cin, ch)
        self.branches = nn.ModuleList(
            [_cbr(cin, ch)] + [nn.Sequential(SepConv(cin, ch, d)) for d in dilations[1:]])

    def forward(self, x):
        B, _, H, W = x.shape
        pooled = _run_cbr(self.image_pool_conv, x.mean(dim=(2, 3), keepdim=True))
        outs = [pooled.expand(B, pooled.shape[1], H, W), _run_cbr(self.branches[0], x)]
        outs += [br[0](x) for br in self.branches[1:]]
        return torch.cat(outs, dim=1)


class Head(nn.Module):
    def __init__(self, n_classes: int, m: Dict):
        super().__init__()
        cin, c1in = 2048, 256
        ch, c1, proj = m["aspp_channels"], m["c1_channels"], m["proj_dim"]
        self.proj_head = nn.Module()
        self.proj_head.proj = nn.Sequential(Conv(cin, cin, 1), BN(cin), nn.ReLU(),
                                            Conv(cin, proj, 1))
        self.aspp = ASPP(cin, ch, m["dilations"])
        self.bottleneck = _cbr(ch * (len(m["dilations"]) + 1), ch)
        self.c1_bottleneck = _cbr(c1in, c1)
        self.sep_bottleneck = nn.Sequential(SepConv(ch + c1, ch), SepConv(ch, ch))
        self.cls_seg = Conv(ch, n_classes, 1, bias=True)
        self.register_buffer("step", torch.zeros(1, dtype=torch.long))

    def embedding(self, c4):
        p = self.proj_head.proj
        y = p[3](F.relu(p[1](p[0](c4))))
        return y * torch.rsqrt(y.square().sum(dim=1, keepdim=True) + 1e-12)

    def logits(self, c1, c4):
        y = _run_cbr(self.bottleneck, self.aspp(c4))
        skip = _run_cbr(self.c1_bottleneck, c1)
        y = F.interpolate(y, size=c1.shape[-2:], mode="bilinear", align_corners=False)
        y = self.sep_bottleneck(torch.cat([y, skip], dim=1))
        return self.cls_seg(y)


class Segmenter(nn.Module):
    """``forward(images NCHW f32, with_train_heads)`` → dict of ``logits``
    ``[B, C, H/4, W/4]`` and, for training, ``embedding`` and
    ``aux_logits`` (all f32)."""

    def __init__(self, depth: int, n_classes: int, n_fine: int, m: Dict,
                 output_stride: int = 32):
        super().__init__()
        self.backbone = Backbone(depth, output_stride)
        self.aspp_head = Head(n_classes, m)
        self.aux_head = nn.Sequential(Conv(1024, n_fine, 1), BN(n_fine), nn.ReLU())

    def forward(self, x, with_train_heads: bool = True):
        c1, _, c3, c4 = self.backbone(x)
        out = {"logits": self.aspp_head.logits(c1, c4)}
        if with_train_heads:
            out["embedding"] = self.aspp_head.embedding(c4)
            a = self.aux_head
            out["aux_logits"] = F.relu(a[1](a[0](c3)))
        return out


MODEL_DEFAULTS = {"aspp_channels": 512, "c1_channels": 48, "proj_dim": 256,
                  "dilations": (1, 12, 24, 36)}


def build(model_cfg: Dict, tree) -> Segmenter:
    """The reference model of a config's ``model`` section (on the meta
    device: ``hbench.core.weights`` fills it) and its label tree."""
    m = dict(MODEL_DEFAULTS, **{k: v for k, v in model_cfg.items() if k in MODEL_DEFAULTS})
    with torch.device("meta"):
        return Segmenter(int(model_cfg["depth"]), tree.total, tree.n_fine, m,
                         int(model_cfg.get("output_stride", 32)))
