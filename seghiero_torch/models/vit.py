"""The plain Vision Transformer with ViTDet's simple feature pyramid — the
port of ``seghiero_tpu/models/vit.py`` (Dosovitskiy et al.,
arXiv:2010.11929; Li et al., arXiv:2203.16527 §3).

A ``patch``-strided convolution embeds the image, a CLS token is put in
front and, with ``n_register``, register tokens after it (DINOv2 with
registers, arXiv:2309.16588). The learned position table holds the CLS
slot and a ``pos_grid × pos_grid`` grid (224 / patch unless given); it is
resized to the input's grid inside every forward pass by the torch-bicubic
matrices (cubic convolution, A = −0.75, half-pixel centres, clamped
borders) in f32, so its gradient reaches ``pos_embed`` and a CUDA graph of
the step holds the resize (the matrices are made at a grid's first, eager
call and cached). The registers take no position. Then ``depth``
pre-norm blocks over every token:

* global attention: a fused ``qkv`` projection whose output is viewed as
  ``q, k, v [B, h, N, d]`` without a copy, and ``ops.attention.
  sr_attention`` with as many keys as queries (the hand-written pair
  #10 / #10b on the card in bf16);
* MLP: linear → exact GELU → linear;

each branch optionally scaled by LayerScale (``layer_scale_init`` > 0)
and dropped per sample by stochastic depth; a final LayerNorm (eps
``norm_eps``, 1e-6) computes in f32 and rounds to its input's dtype.

The stride-16 map of the patch tokens alone feeds the simple feature
pyramid, which gives (C1, C2, C3, C4) at strides 4/8/16/32 with widths
(D/4, D/2, D, D): ``fpn1`` a 2×2/2 deconvolution → LayerNorm over the
channels → exact GELU → 2×2/2 deconvolution, ``fpn2`` one 2×2/2
deconvolution, the map itself, and a 2×2/2 max-pool. The maps are NCHW
views of NHWC memory.

Parameter names are timm's (``patch_embed.proj``, ``cls_token``,
``reg_token``, ``pos_embed``, ``blocks.{i}.norm1``, ``.attn.qkv``,
``.attn.proj``, ``.ls1.gamma``, ``.norm2``, ``.mlp.fc1``, ``.mlp.fc2``,
``.ls2.gamma``, ``norm``) and mmseg's for the pyramid (``fpn1.0``,
``fpn1.1``, ``fpn1.3``, ``fpn2.0``), so a pretrained file is a key map
away; ``models/convert.py`` carries the JAX package's across. The
attention of each block is the span ``vit.attention``, the pyramid
``vit.pyramid``.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from seghiero_torch import trace
from seghiero_torch.models.mit import LayerNorm, drop_path
from seghiero_torch.ops.attention import sr_attention

# (embed dim, depth, heads): arXiv:2010.11929 Table 1 and timm's tiny and small
VARIANTS = {
    "tiny": (192, 12, 3),
    "small": (384, 12, 6),
    "base": (768, 12, 12),
    "large": (1024, 24, 16),
}
MLP_RATIO = 4


def cubic_resize_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """``[n_out, n_in]`` f32 matrix of ``F.interpolate(mode="bicubic",
    align_corners=False)`` along one axis: cubic convolution with A = −0.75
    at half-pixel centres, the taps past a border clamped onto it."""
    A = -0.75
    W = torch.zeros((n_out, n_in), dtype=torch.float64)
    for i in range(n_out):
        center = (i + 0.5) * n_in / n_out - 0.5
        i0 = math.floor(center)
        t = center - i0
        taps = (((A * (t + 1) - 5 * A) * (t + 1) + 8 * A) * (t + 1) - 4 * A,
                ((A + 2) * t - (A + 3)) * t * t + 1,
                ((A + 2) * (1 - t) - (A + 3)) * (1 - t) * (1 - t) + 1,
                ((A * (2 - t) - 5 * A) * (2 - t) + 8 * A) * (2 - t) - 4 * A)
        for k, w in enumerate(taps):
            W[i, min(max(i0 - 1 + k, 0), n_in - 1)] += w
    return W.to(torch.float32)


@functools.lru_cache(maxsize=None)
def resize_matrix(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """:func:`cubic_resize_matrix` on ``device``, made at a shape's first call
    and read thereafter (a CUDA graph's capture then finds it made)."""
    return cubic_resize_matrix(n_in, n_out).to(device)


def resize_pos_embed(pos: torch.Tensor, grid: Tuple[int, int],
                     new_grid: Tuple[int, int]) -> torch.Tensor:
    """``[1, 1 + gh·gw, D]`` → ``[1, 1 + nh·nw, D]`` f32: the CLS slot kept,
    the grid resized rows then columns, each one small matrix product in
    f32 (autocast off)."""
    if tuple(grid) == tuple(new_grid):
        return pos.float()
    (gh, gw), (nh, nw) = grid, new_grid
    with torch.autocast(pos.device.type, enabled=False):
        p = pos[0, 1:].float().view(gh, gw, -1)
        p = torch.einsum("Hh,hwd->Hwd", resize_matrix(gh, nh, pos.device), p)
        p = torch.einsum("Ww,hwd->hWd", resize_matrix(gw, nw, pos.device), p)
        return torch.cat([pos[:, :1].float(), p.reshape(1, nh * nw, -1)], dim=1)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Attention(nn.Module):
    """Multi-head self-attention over every token, with a fused ``qkv``
    (q, k, v concatenated along the output axis)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        h = self.num_heads
        qkv = self.qkv(x)
        with trace.span("vit.attention"):
            q, k, v = qkv.view(B, N, 3, h, C // h).permute(2, 0, 3, 1, 4)
            y = sr_attention(q, k, v).transpose(1, 2).reshape(B, N, C)
        return self.proj(y)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, drop_path: float, layer_scale_init: float,
                 norm_eps: float):
        super().__init__()
        self.norm1 = LayerNorm(dim, norm_eps)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim, norm_eps)
        self.mlp = Mlp(dim, MLP_RATIO * dim)
        if layer_scale_init:
            self.ls1 = LayerScale(dim, layer_scale_init)
            self.ls2 = LayerScale(dim, layer_scale_init)
        else:
            self.ls1 = self.ls2 = nn.Identity()
        self.drop_rate = drop_path

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + drop_path(self.ls1(self.attn(self.norm1(x))), self.drop_rate, self.training)
        return x + drop_path(self.ls2(self.mlp(self.norm2(x))), self.drop_rate, self.training)


class PatchEmbed(nn.Module):
    """``patch``-strided convolution, images NCHW → tokens ``[B, h·w, D]``
    and the grid ``(h, w)``; H and W must be multiples of ``patch``."""

    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)

    def forward(self, x: torch.Tensor):
        p = self.proj.stride[0]
        if x.shape[2] % p or x.shape[3] % p:
            raise ValueError(f"vit patch={p} requires input H/W divisible by it, "
                             f"got {x.shape[2]}x{x.shape[3]}")
        x = self.proj(x.to(self.proj.weight.dtype))
        return x.flatten(2).transpose(1, 2), tuple(x.shape[2:])


class ChannelNorm(LayerNorm):
    """LayerNorm over the channels of an NCHW map (an NHWC view of it)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ViTBackbone(nn.Module):
    """images NCHW → (C1, C2, C3, C4) at strides 4/8/16/32 with channels
    (D/4, D/2, D, D), by the simple feature pyramid of the last block's
    stride-16 map. A plain ViT has no dilation mode: the pyramid and the
    head recover the resolution."""

    def __init__(self, variant: str = "base", patch: int = 16, pos_grid: int = 0,
                 drop_path_rate: float = 0.0, layer_scale_init: float = 0.0,
                 n_register: int = 0, norm_eps: float = 1e-6):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"vit variant must be one of {sorted(VARIANTS)}, got {variant!r}")
        dim, depth, heads = VARIANTS[variant]
        self.n_register = n_register
        self.grid = pos_grid or 224 // patch
        self.widths = (dim // 4, dim // 2, dim, dim)
        self.patch_embed = PatchEmbed(dim, patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.reg_token = nn.Parameter(torch.zeros(1, n_register, dim)) if n_register else None
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + self.grid * self.grid, dim))
        rates = [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
        self.blocks = nn.ModuleList(Block(dim, heads, rates[i], layer_scale_init, norm_eps)
                                    for i in range(depth))
        self.norm = LayerNorm(dim, norm_eps)
        self.fpn1 = nn.Sequential(nn.ConvTranspose2d(dim, dim // 2, 2, stride=2),
                                  ChannelNorm(dim // 2, norm_eps), nn.GELU(),
                                  nn.ConvTranspose2d(dim // 2, dim // 4, 2, stride=2))
        self.fpn2 = nn.Sequential(nn.ConvTranspose2d(dim, dim // 2, 2, stride=2))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        B = x.shape[0]
        tok, (h, w) = self.patch_embed(x)
        pos = resize_pos_embed(self.pos_embed, (self.grid, self.grid), (h, w))
        tok = tok + pos[:, 1:].to(tok.dtype)
        extras = [(self.cls_token.float() + pos[:, :1]).to(tok.dtype).expand(B, -1, -1)]
        if self.reg_token is not None:
            extras.append(self.reg_token.to(tok.dtype).expand(B, -1, -1))
        tok = torch.cat(extras + [tok], dim=1)
        for block in self.blocks:
            tok = block(tok)
        tok = self.norm(tok)
        with trace.span("vit.pyramid"):
            feat = tok[:, 1 + self.n_register:].reshape(B, h, w, -1).permute(0, 3, 1, 2)
            return (self.fpn1(feat), self.fpn2(feat), feat, F.max_pool2d(feat, 2, 2))
