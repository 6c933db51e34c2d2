"""Decode heads (NCHW) — the port of ``seghiero_tpu/models/heads.py``.

Module and parameter names follow the reference checkpoint's
``aspp_head`` / ``aux_head`` state dicts, so a reference ``.pth`` or a
converted JAX model loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from seghiero_torch.models.resnet import batch_norm, conv
from seghiero_torch.ops.depthwise import depthwise3x3, depthwise3x3_dilated_forward
from seghiero_torch.ops.resize import resize_bilinear


def _conv_bn_relu(cin: int, cout: int, kernel: int = 1) -> nn.Sequential:
    return nn.Sequential(conv(cin, cout, kernel), batch_norm(cout), nn.ReLU(inplace=True))


class ProjectionHead(nn.Module):
    """Per-pixel L2-normalized embedding: 'linear' = 1×1 conv, 'convmlp' =
    1×1 → BN → ReLU → 1×1. The norm is ``y·rsqrt(Σy² + 1e-12)`` in f32, as
    in the JAX package (not ``F.normalize``)."""

    def __init__(self, cin: int, proj_dim: int = 256, proj_type: str = "convmlp"):
        super().__init__()
        if proj_type == "linear":
            self.proj = conv(cin, proj_dim, 1)
        elif proj_type == "convmlp":
            self.proj = nn.Sequential(
                conv(cin, cin, 1), batch_norm(cin), nn.ReLU(inplace=True),
                conv(cin, proj_dim, 1),
            )
        else:
            raise ValueError(f"Unknown proj type: {proj_type}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.proj(x).to(torch.float32)
        return y * torch.rsqrt(y.square().sum(dim=1, keepdim=True) + 1e-12)


class DepthwiseConv(nn.Conv2d):
    """k×k depthwise conv (one filter per channel, weight ``[C, 1, k, k]``).

    With ``use_kernel`` the 3×3 / dilation-1 case goes to
    ``ops.depthwise.depthwise3x3`` (the hand-written kernels on the card,
    their plain versions on the CPU), and a dilated 3×3 call from which
    autograd needs no backward (inference, evaluation) to
    ``ops.depthwise.depthwise3x3_dilated_forward``; every other case, and
    ``use_kernel=False``, goes to ``F.conv2d(groups=C)``."""

    def __init__(self, channels: int, kernel: int = 3, dilation: int = 1,
                 use_kernel: bool = False):
        pad = dilation * (kernel - 1) // 2
        super().__init__(channels, channels, kernel, padding=pad, dilation=dilation,
                         groups=channels, bias=False)
        self.use_kernel = use_kernel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dilation[0]
        needs_grad = torch.is_grad_enabled() and (x.requires_grad or self.weight.requires_grad)
        if self.use_kernel and self.kernel_size[0] == 3 and (d == 1 or not needs_grad):
            C = x.shape[1]
            k9 = self.weight.reshape(C, 9).t().contiguous().to(x.dtype)
            x_nhwc = x.permute(0, 2, 3, 1)
            y = (depthwise3x3(x_nhwc, k9) if d == 1
                 else depthwise3x3_dilated_forward(x_nhwc, k9, d))
            return y.permute(0, 3, 1, 2)
        return F.conv2d(x, self.weight.to(x.dtype), None, 1, self.padding,
                        self.dilation, self.groups)


class DepthwiseSeparableConv(nn.Module):
    """depthwise (k×k, dilated) → BN → ReLU → pointwise 1×1 → BN → ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, dilation: int = 1,
                 dw_kernel: bool = False):
        super().__init__()
        self.depthwise = DepthwiseConv(cin, kernel, dilation, use_kernel=dw_kernel)
        self.bn_dw = batch_norm(cin)
        self.pointwise = conv(cin, cout, 1)
        self.bn_pw = batch_norm(cout)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn_dw(self.depthwise(x)))
        return self.relu(self.bn_pw(self.pointwise(y)))


class DepthwiseSeparableASPP(nn.Module):
    """Global-pool branch + 1×1 branch + one dilated separable branch per
    ``dilations[1:]``, concatenated in the order [image_pool, 1×1, sep(d)…].
    The pool branch is a broadcast of its 1×1 result."""

    def __init__(self, cin: int, channels: int, dilations: Sequence[int] = (1, 12, 24, 36),
                 dw_kernel: bool = False):
        super().__init__()
        self.image_pool_conv = _conv_bn_relu(cin, channels)
        branches = [_conv_bn_relu(cin, channels)]
        for d in dilations[1:]:
            branches.append(nn.Sequential(
                DepthwiseSeparableConv(cin, channels, 3, dilation=d, dw_kernel=dw_kernel)
            ))
        self.branches = nn.ModuleList(branches)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, H, W = x.shape
        pooled = self.image_pool_conv(x.mean(dim=(2, 3), keepdim=True))
        outs = [pooled.expand(B, pooled.shape[1], H, W)]
        outs += [branch(x) for branch in self.branches]
        return torch.cat(outs, dim=1)


class SepASPPContrastHead(nn.Module):
    """DeepLabV3+-style head with a contrastive projection.

    forward(feats, outputs) → (logits ``[B, num_classes, H/4, W/4]`` f32 or
    None, embedding ``[B, proj_dim, h4, w4]`` f32 or None); each is computed
    only when named in ``outputs``."""

    def __init__(self, num_classes: int, in_channels: int, c1_in_channels: int,
                 c1_channels: int = 48, aspp_channels: int = 512,
                 dilations: Sequence[int] = (1, 12, 24, 36), proj_dim: int = 256,
                 proj_type: str = "convmlp", dw_kernel: bool = False):
        super().__init__()
        self.proj_head = ProjectionHead(in_channels, proj_dim, proj_type)
        self.aspp = DepthwiseSeparableASPP(in_channels, aspp_channels, dilations, dw_kernel)
        self.bottleneck = _conv_bn_relu(aspp_channels * (len(dilations) + 1), aspp_channels)
        self.c1_bottleneck = _conv_bn_relu(c1_in_channels, c1_channels)
        self.sep_bottleneck = nn.Sequential(
            DepthwiseSeparableConv(aspp_channels + c1_channels, aspp_channels, 3,
                                   dw_kernel=dw_kernel),
            DepthwiseSeparableConv(aspp_channels, aspp_channels, 3, dw_kernel=dw_kernel),
        )
        self.cls_seg = nn.Conv2d(aspp_channels, num_classes, 1, bias=True)
        # the reference head registers a forward counter nothing reads; it
        # is kept so reference state dicts load strictly
        self.register_buffer("step", torch.zeros(1, dtype=torch.long))

    def forward(
        self, feats: Sequence[torch.Tensor], outputs: Sequence[str] = ("logits", "embedding")
    ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        c1, c4 = feats[0], feats[-1]
        embedding = self.proj_head(c4) if "embedding" in outputs else None
        logits = None
        if "logits" in outputs:
            y = self.bottleneck(self.aspp(c4))
            skip = self.c1_bottleneck(c1)
            y = resize_bilinear(y.to(torch.float32), c1.shape[-2:]).to(skip.dtype)
            y = self.sep_bottleneck(torch.cat([y, skip], dim=1))
            logits = self.cls_seg(y).to(torch.float32)
        return logits, embedding


class SegFormerMLPHead(nn.Module):
    """SegFormer's all-MLP decoder (the JAX package's
    ``decode_heads.SegFormerMLPHead``): a linear projection of each stage
    to ``channels``, bilinear to the stride-4 grid
    (``ops.resize.resize_bilinear`` in f32), the concatenation ``[c4, c3,
    c2, c1]``, a 1×1 conv → BN → ReLU fuse, dropout (training) and the 1×1
    classifier; the embedding is a ``ProjectionHead`` on C4.

    forward(feats, outputs) → (logits ``[B, num_classes, H/4, W/4]`` f32 or
    None, embedding ``[B, proj_dim, H/32, W/32]`` f32 or None), each only
    when named in ``outputs``."""

    def __init__(self, num_classes: int, widths: Sequence[int], channels: int = 256,
                 dropout_rate: float = 0.1, proj_dim: int = 256, proj_type: str = "convmlp"):
        super().__init__()
        self.proj_head = ProjectionHead(widths[3], proj_dim, proj_type)
        for i, w in enumerate(widths, start=1):
            self.add_module(f"linear_c{i}", nn.Linear(w, channels))
        self.linear_fuse = _conv_bn_relu(4 * channels, channels)
        self.dropout = nn.Dropout(dropout_rate)
        self.cls_seg = nn.Conv2d(channels, num_classes, 1, bias=True)

    def forward(
        self, feats: Sequence[torch.Tensor], outputs: Sequence[str] = ("logits", "embedding")
    ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        embedding = self.proj_head(feats[3]) if "embedding" in outputs else None
        logits = None
        if "logits" in outputs:
            hw = feats[0].shape[-2:]
            parts = []
            for i, x in enumerate(feats, start=1):
                # on the NHWC view: a linear layer over the channels, then NCHW again
                y = getattr(self, f"linear_c{i}")(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
                if y.shape[-2:] != hw:
                    y = resize_bilinear(y.to(torch.float32), hw).to(y.dtype)
                parts.append(y)
            y = self.linear_fuse(torch.cat(parts[::-1], dim=1))
            logits = self.cls_seg(self.dropout(y)).to(torch.float32)
        return logits, embedding


class UPerNetHead(nn.Module):
    """UPerNet (Xiao et al., arXiv:1807.10221; the JAX package's
    ``decode_heads.UPerNetHead``): a pyramid pooling module on C4
    (``F.adaptive_avg_pool2d`` at each of ``pool_scales``, its uneven bins
    as torch's, a 1×1 conv → BN → ReLU each, bilinear back in f32, the
    concatenation ``[C4, pools…]`` and a 3×3 ``bottleneck``), 1×1 laterals
    on C1–C3 summed top-down with the bilinear upsample of the level above,
    3×3 FPN convs, every level bilinear to the stride-4 grid, their
    concatenation through a 3×3 ``fpn_bottleneck``, dropout (training) and
    the 1×1 classifier; the embedding is a ``ProjectionHead`` on C4. Module
    names are mmseg's ``UPerHead``'s (``psp_modules``, ``bottleneck``,
    ``lateral_convs``, ``fpn_convs``, ``fpn_bottleneck``) but for the
    classifier, ``cls_seg`` as in the port's other heads.

    forward(feats, outputs) → (logits ``[B, num_classes, H/4, W/4]`` f32 or
    None, embedding ``[B, proj_dim, H/32, W/32]`` f32 or None), each only
    when named in ``outputs``."""

    def __init__(self, num_classes: int, widths: Sequence[int], channels: int = 512,
                 pool_scales: Sequence[int] = (1, 2, 3, 6), dropout_rate: float = 0.1,
                 proj_dim: int = 256, proj_type: str = "convmlp"):
        super().__init__()
        self.pool_scales = tuple(pool_scales)
        self.proj_head = ProjectionHead(widths[3], proj_dim, proj_type)
        self.psp_modules = nn.ModuleList(_conv_bn_relu(widths[3], channels)
                                         for _ in self.pool_scales)
        self.bottleneck = _conv_bn_relu(widths[3] + len(self.pool_scales) * channels, channels, 3)
        self.lateral_convs = nn.ModuleList(_conv_bn_relu(w, channels) for w in widths[:3])
        self.fpn_convs = nn.ModuleList(_conv_bn_relu(channels, channels, 3) for _ in range(3))
        self.fpn_bottleneck = _conv_bn_relu(4 * channels, channels, 3)
        self.dropout = nn.Dropout(dropout_rate)
        self.cls_seg = nn.Conv2d(channels, num_classes, 1, bias=True)

    def forward(
        self, feats: Sequence[torch.Tensor], outputs: Sequence[str] = ("logits", "embedding")
    ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        c1, c2, c3, c4 = feats
        embedding = self.proj_head(c4) if "embedding" in outputs else None
        if "logits" not in outputs:
            return None, embedding
        hw4 = c4.shape[-2:]
        psp = [c4]
        for s, m in zip(self.pool_scales, self.psp_modules):
            y = m(F.adaptive_avg_pool2d(c4, s))
            psp.append(resize_bilinear(y.to(torch.float32), hw4).to(y.dtype))
        lat = [m(x) for m, x in zip(self.lateral_convs, (c1, c2, c3))]
        lat.append(self.bottleneck(torch.cat(psp, dim=1)))
        for i in (2, 1, 0):
            up = resize_bilinear(lat[i + 1].to(torch.float32), lat[i].shape[-2:])
            lat[i] = lat[i] + up.to(lat[i].dtype)
        outs = [m(x) for m, x in zip(self.fpn_convs, lat[:3])] + [lat[3]]
        hw1 = c1.shape[-2:]
        outs = [o if o.shape[-2:] == hw1 else resize_bilinear(o.to(torch.float32), hw1).to(o.dtype)
                for o in outs]
        y = self.fpn_bottleneck(torch.cat(outs, dim=1))
        return self.cls_seg(self.dropout(y)).to(torch.float32), embedding


class AuxHead(nn.Sequential):
    """1×1 conv → BN → ReLU on C3, fine classes only (the ReLU after the
    classifier is the reference's)."""

    def __init__(self, cin: int, n_fine: int):
        super().__init__(conv(cin, n_fine, 1), batch_norm(n_fine), nn.ReLU(inplace=True))

    def forward(self, c3: torch.Tensor) -> torch.Tensor:
        return super().forward(c3).to(torch.float32)
