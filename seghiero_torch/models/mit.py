"""MiT (Mix Transformer), SegFormer's encoder — the port of
``seghiero_tpu/models/mit.py`` (Xie et al., arXiv:2105.15203).

Four stages, each an overlapping patch embedding (a 7×7/4, then 3×3/2
convolution and a LayerNorm), transformer blocks and a final LayerNorm.
A block is pre-norm with two residual branches:

* spatial-reduction attention: queries at full resolution, keys and
  values from an ``sr``-strided convolution and a LayerNorm
  (``ops.attention.sr_attention``: flash or memory-efficient on the card);
* Mix-FFN: linear → 3×3 depthwise convolution with its bias → exact GELU
  → linear.

The blocks keep token-major ``[B, N, C]`` activations, which viewed as
``[B, H, W, C]`` are NHWC-contiguous: with ``model.depthwise_backend:
pallas`` the Mix-FFN's depthwise convolution takes that view as it is
(``ops.depthwise.depthwise3x3``, kernels #1, #1b and #2 on the card),
and each stage's output is its NCHW view (channels_last, no copy).
LayerNorm (eps 1e-6) computes in f32 and rounds to its input's dtype, as
flax's does; drop path is per sample. Parameter names are those of the
official release (``patch_embed{i}``, ``block{i}.{j}``, ``norm{i}``,
``attn.q`` / ``attn.kv`` / ``attn.sr`` / ``attn.norm`` / ``attn.proj``,
``mlp.fc1`` / ``mlp.dwconv`` / ``mlp.fc2``); ``models/convert.py``
carries the JAX package's (separate ``k`` and ``v``) across.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from seghiero_torch.ops.attention import sr_attention
from seghiero_torch.ops.depthwise import depthwise3x3

# depths and embed dims per stage; heads, sr ratios and the MLP ratio are
# shared by every variant
VARIANTS = {
    "b0": ((2, 2, 2, 2), (32, 64, 160, 256)),
    "b1": ((2, 2, 2, 2), (64, 128, 320, 512)),
    "b2": ((3, 4, 6, 3), (64, 128, 320, 512)),
    "b3": ((3, 4, 18, 3), (64, 128, 320, 512)),
    "b4": ((3, 8, 27, 3), (64, 128, 320, 512)),
    "b5": ((3, 6, 40, 3), (64, 128, 320, 512)),
}
NUM_HEADS = (1, 2, 5, 8)
SR_RATIOS = (8, 4, 2, 1)
MLP_RATIO = 4
PATCH = ((7, 4), (3, 2), (3, 2), (3, 2))  # (kernel, stride) per stage


class LayerNorm(nn.LayerNorm):
    """eps 1e-6 (MiT's; Swin's is 1e-5); statistics and affine in f32, the
    result in the input's dtype (a bf16 residual stream stays bf16, as in
    the JAX package)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


def _nchw(tokens: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """``[B, H·W, C]`` tokens as an NCHW view (channels_last)."""
    B, _, C = tokens.shape
    return tokens.view(B, H, W, C).permute(0, 3, 1, 2)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW → ``[B, H·W, C]`` (no copy for a channels_last map)."""
    B, C, H, W = x.shape
    return x.permute(0, 2, 3, 1).reshape(B, H * W, C)


def drop_path(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """Per-sample stochastic depth: a sample's branch is dropped with
    probability ``rate``, the survivors scaled by 1/(1 − rate)."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1), device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class EfficientAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = LayerNorm(dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, N, C = x.shape
        h = self.num_heads
        q = self.q(x).view(B, N, h, C // h).transpose(1, 2)
        r = x
        if self.sr_ratio > 1:
            r = self.norm(_tokens(self.sr(_nchw(x, H, W))))
        M = r.shape[1]
        k, v = self.kv(r).view(B, M, 2, h, C // h).permute(2, 0, 3, 1, 4)
        y = sr_attention(q, k, v).transpose(1, 2).reshape(B, N, C)
        return self.proj(y)


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int, dw_kernel: bool = False):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.dw_kernel = dw_kernel

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        y = self.fc1(x)
        B, N, C = y.shape
        w = self.dwconv.weight
        if self.dw_kernel:
            k9 = w.reshape(C, 9).t().contiguous().to(y.dtype)
            y = depthwise3x3(y.view(B, H, W, C), k9)
        else:
            y = F.conv2d(_nchw(y, H, W), w.to(y.dtype), None, 1, 1, 1, C).permute(0, 2, 3, 1)
        y = F.gelu(y + self.dwconv.bias.to(y.dtype))
        return self.fc2(y.reshape(B, N, C))


class MiTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int, drop_path: float = 0.0,
                 dw_kernel: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = EfficientAttention(dim, num_heads, sr_ratio)
        self.norm2 = LayerNorm(dim)
        self.mlp = MixFFN(dim, MLP_RATIO * dim, dw_kernel)
        self.drop_rate = drop_path

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        x = x + drop_path(self.attn(self.norm1(x), H, W), self.drop_rate, self.training)
        return x + drop_path(self.mlp(self.norm2(x), H, W), self.drop_rate, self.training)


class PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, kernel: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, kernel, stride=stride, padding=kernel // 2)
        self.norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        x = self.proj(x)
        return self.norm(_tokens(x)), x.shape[2], x.shape[3]


class MiTBackbone(nn.Module):
    """images NCHW → (C1, C2, C3, C4) at strides 4/8/16/32 with the
    variant's embed dims, each stage LayerNorm'd, as NCHW views of
    NHWC-contiguous tokens. MiT has no dilation mode: SegFormer's head
    recovers the resolution."""

    def __init__(self, variant: str = "b0", drop_path_rate: float = 0.0,
                 dw_kernel: bool = False):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"mit variant must be one of {sorted(VARIANTS)}, got {variant!r}")
        depths, dims = VARIANTS[variant]
        self.widths = dims
        total = sum(depths)
        rates = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        cin, i = 3, 0
        for s, (depth, dim) in enumerate(zip(depths, dims), start=1):
            kernel, stride = PATCH[s - 1]
            self.add_module(f"patch_embed{s}", PatchEmbed(cin, dim, kernel, stride))
            self.add_module(f"block{s}", nn.ModuleList(
                MiTBlock(dim, NUM_HEADS[s - 1], SR_RATIOS[s - 1], rates[i + j], dw_kernel)
                for j in range(depth)))
            self.add_module(f"norm{s}", LayerNorm(dim))
            cin, i = dim, i + depth

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        feats = []
        for s in range(1, 5):
            x, H, W = getattr(self, f"patch_embed{s}")(x)
            for block in getattr(self, f"block{s}"):
                x = block(x, H, W)
            x = _nchw(getattr(self, f"norm{s}")(x), H, W)
            feats.append(x)
        return tuple(feats)
