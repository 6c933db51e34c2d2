"""Swin Transformer, the windowed-attention encoder — the port of
``seghiero_tpu/models/swin.py`` (Liu et al., arXiv:2103.14030).

A 4×4 patch embedding (convolution and LayerNorm), then four stages of
blocks that alternate window attention (W-MSA) and shifted-window
attention (SW-MSA), with a 2×2 patch merging between stages. A block is
pre-norm with two residual branches:

* window attention: the LayerNorm'd map zero-padded to window multiples,
  rolled by −w/2 in a shifted block, cut into ``w×w`` windows, multi-head
  attention inside each window with the learned relative-position bias
  (a ``(2w−1)² × heads`` table gathered into every score) and, in a
  shifted block, the region mask (−100 across regions), the windows put
  back, rolled back and the padding sliced off (``ops.attention.
  window_attention``: SDPA's memory-efficient kernels on the card);
* MLP: linear → exact GELU → linear.

Maps smaller than a window are padded up to it and shifted blocks keep
shifting: the JAX package's always-partition semantics (HF
``SwinBackbone``, mmseg). Patch merging concatenates the 2×2 neighbours
in the order (0,0), (1,0), (0,1), (1,1), then LayerNorm → Linear 4C→2C
without bias. Each stage's output, before the merging, gets a LayerNorm
of its own.

Blocks keep NHWC ``[B, H, W, C]`` maps; the stage outputs are their NCHW
views (channels_last, no copy), with widths (C, 2C, 4C, 8C). LayerNorm
(eps 1e-5) computes in f32 and rounds to its input's dtype; drop path is
per sample. The relative-position index and the shift masks are
constants on the model's device that the state dict does not hold: the
index a non-persistent buffer, the masks cached by padded shape, filled
by the first call of a shape (the step's eager calls, before a CUDA
graph captures it). Parameter names are those of the official release
(``patch_embed.proj``, ``layers.{s}.blocks.{j}.attn.qkv``,
``.attn.relative_position_bias_table``, ``.attn.proj``, ``.mlp.fc1`` /
``.mlp.fc2``, ``layers.{s}.downsample.reduction``, ``norm{s}``), so a
pretrained file is a key map away; ``models/convert.py`` carries the JAX
package's (separate ``q``, ``k``, ``v``) across. Each block's padding,
shift, partition, attention and their inverses are the span
``swin.attention``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from seghiero_torch import trace
from seghiero_torch.models.mit import LayerNorm, drop_path
from seghiero_torch.ops.attention import window_attention

#          embed dim  depths          heads
VARIANTS = {
    "tiny": (96, (2, 2, 6, 2), (3, 6, 12, 24)),
    "small": (96, (2, 2, 18, 2), (3, 6, 12, 24)),
    "base": (128, (2, 2, 18, 2), (4, 8, 16, 32)),
    "large": (192, (2, 2, 18, 2), (6, 12, 24, 48)),
}
MLP_RATIO = 4
PATCH = 4
LN_EPS = 1e-5


def relative_position_index(w: int, device=None) -> torch.Tensor:
    """``[w², w²]`` index into the ``(2w−1)²`` bias table: row-major
    offsets ``(Δy + w − 1)·(2w − 1) + Δx + w − 1`` (the published
    construction)."""
    ys, xs = torch.meshgrid(torch.arange(w, device=device), torch.arange(w, device=device),
                            indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    return (ys[:, None] - ys[None, :] + w - 1) * (2 * w - 1) + xs[:, None] - xs[None, :] + w - 1


def shift_mask(hp: int, wp: int, w: int, shift: int, device=None) -> torch.Tensor:
    """The shifted windows' region mask ``[nW, w², w²]`` f32 of an
    ``hp × wp`` padded map: 0 within a region, −100 across regions (the
    published slice construction), made on ``device``."""
    img = torch.zeros((hp, wp), device=device)
    cuts = (slice(0, -w), slice(-w, -shift), slice(-shift, None))
    for i, hs in enumerate(cuts):
        for j, ws in enumerate(cuts):
            img[hs, ws] = 3 * i + j
    win = window_partition(img[None, :, :, None], w)[..., 0]  # [nW, w²]
    return torch.where(win[:, None, :] != win[:, :, None], -100.0, 0.0)


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """``[B, H, W, C]`` → ``[B·nH·nW, w², C]``, windows batch-major, then
    row-major (H and W multiples of w)."""
    B, H, W, C = x.shape
    x = x.view(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, C)


def window_reverse(win: torch.Tensor, w: int, B: int, H: int, W: int) -> torch.Tensor:
    """Inverse of :func:`window_partition`."""
    x = win.view(B, H // w, W // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, -1)


class WindowAttention(nn.Module):
    """Multi-head attention inside ``w×w`` windows, ``[B·nW, w², C]`` →
    the same, with the learned relative-position bias and an optional
    region mask ``[nW, w², w²]``."""

    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.num_heads, self.window = num_heads, window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             relative_position_index(window).reshape(-1), persistent=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        Bw, N, C = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).view(Bw, N, 3, h, C // h).permute(2, 0, 3, 1, 4)
        bias = self.relative_position_bias_table[self.relative_position_index]
        bias = bias.view(N, N, h).permute(2, 0, 1).contiguous()[None]  # [1, h, N, N]
        if mask is not None:  # [nW, N, N], the same for every image of the batch
            nW = mask.shape[0]
            bias = (bias + mask[:, None]).expand(Bw // nW, nW, h, N, N).reshape(Bw, h, N, N)
        y = window_attention(q, k, v, bias)
        return self.proj(y.transpose(1, 2).reshape(Bw, N, C))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """``shift`` 0 is W-MSA, ``window // 2`` SW-MSA."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 drop_path: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, LN_EPS)
        self.attn = WindowAttention(dim, num_heads, window)
        self.norm2 = LayerNorm(dim, LN_EPS)
        self.mlp = Mlp(dim, MLP_RATIO * dim)
        self.shift, self.drop_rate = shift, drop_path

    def forward(self, x: torch.Tensor, masks: "ShiftMasks") -> torch.Tensor:
        B, H, W, _ = x.shape
        w, s = self.attn.window, self.shift
        y = self.norm1(x)
        with trace.span("swin.attention"):
            ph, pw = (-H) % w, (-W) % w
            if ph or pw:
                y = F.pad(y, (0, 0, 0, pw, 0, ph))
            Hp, Wp = H + ph, W + pw
            if s:
                y = torch.roll(y, (-s, -s), (1, 2))
            y = self.attn(window_partition(y, w), masks.get(Hp, Wp, y.device) if s else None)
            y = window_reverse(y, w, B, Hp, Wp)
            if s:
                y = torch.roll(y, (s, s), (1, 2))
            if ph or pw:
                y = y[:, :H, :W]
        x = x + drop_path(y, self.drop_rate, self.training)
        return x + drop_path(self.mlp(self.norm2(x)), self.drop_rate, self.training)


class PatchMerging(nn.Module):
    """2×2 concatenation ((0,0), (1,0), (0,1), (1,1); odd H or W padded
    with zeros first) → LayerNorm → Linear 4C→2C without bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[1:3]
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.reduction(self.norm(x))


class PatchEmbed(nn.Module):
    """4×4/4 convolution (the input zero-padded to multiples of 4 as
    flax's ``SAME`` pads: the odd row or column after) → LayerNorm; NCHW
    images → NHWC map."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH, stride=PATCH)
        self.norm = LayerNorm(dim, LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph, pw = (-x.shape[2]) % PATCH, (-x.shape[3]) % PATCH
        if ph or pw:
            x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class BasicLayer(nn.Module):
    """One stage's blocks (``blocks``) and, but for the last stage, the
    patch merging that follows its output (``downsample``)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window: int, rates,
                 downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window, 0 if j % 2 == 0 else window // 2, rates[j])
            for j in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None


class ShiftMasks:
    """The shifted blocks' region masks (window ``w``, shift ``w // 2``) by
    padded shape and device: made on the device at a shape's first call,
    read thereafter (a CUDA graph's capture then finds them made)."""

    def __init__(self, window: int):
        self.window = window
        self._masks: Dict[tuple, torch.Tensor] = {}

    def get(self, hp: int, wp: int, device) -> torch.Tensor:
        key = (hp, wp, device)
        if key not in self._masks:
            self._masks[key] = shift_mask(hp, wp, self.window, self.window // 2, device)
        return self._masks[key]


class SwinBackbone(nn.Module):
    """images NCHW → (C1, C2, C3, C4) at strides 4/8/16/32 with channels
    (C, 2C, 4C, 8C), each stage LayerNorm'd, as NCHW views of NHWC maps.
    Swin has no dilation mode: UperNet's head recovers the resolution."""

    def __init__(self, variant: str = "tiny", window: int = 7, drop_path_rate: float = 0.0):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"swin variant must be one of {sorted(VARIANTS)}, got {variant!r}")
        dim, depths, heads = VARIANTS[variant]
        self.widths = (dim, 2 * dim, 4 * dim, 8 * dim)
        total = sum(depths)
        rates = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        self.patch_embed = PatchEmbed(dim)
        self.layers = nn.ModuleList()
        i = 0
        for s, (depth, h) in enumerate(zip(depths, heads)):
            self.layers.append(BasicLayer(self.widths[s], depth, h, window,
                                          rates[i:i + depth], s < 3))
            self.add_module(f"norm{s}", LayerNorm(self.widths[s], LN_EPS))
            i += depth
        self.masks = ShiftMasks(window)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.patch_embed(x)
        feats = []
        for s, layer in enumerate(self.layers):
            for block in layer.blocks:
                x = block(x, self.masks)
            feats.append(getattr(self, f"norm{s}")(x).permute(0, 3, 1, 2))
            if layer.downsample is not None:
                x = layer.downsample(x)
        return tuple(feats)
