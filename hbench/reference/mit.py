"""The plain float32 reference of SegFormer: the Mix Transformer encoder
(MiT b0–b5) with SegFormer's all-MLP head, its contrastive projection on
C4 and the aux head on C3 (Xie et al., arXiv:2105.15203), written in
plain ``torch.nn.functional`` calls. It imports nothing of the program.

* Attention is two matrix products and a softmax, taken over blocks of
  queries so that the score matrix of MiT's first stage (65 536 × 1 024
  at 1024²) is never whole; ``core/flops.py`` counts the products.
* The Mix-FFN's 3×3 depthwise convolution is a grouped ``F.conv2d``, so
  ``core/geometry.py`` finds every one.
* Under the control (``lowp.enabled``) every matrix product and
  convolution takes fp8 operands (``lowp.q8``).

Module and parameter names are the program's (``backbone.block{s}.{j}.
attn.kv``, ``aspp_head.linear_fuse.1``, ...), so one state dict made by
``hbench.core.weights`` loads into both. Drop path and dropout draw
random masks no comparison could match: ``build`` refuses them.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from hbench.reference import lowp
from hbench.reference.model import BN, Conv, _cbr, conv

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
PATCH = ((7, 4), (3, 2), (3, 2), (3, 2))
LN_EPS = 1e-6
QUERY_BLOCK = 16384
# each residual branch's last layer: no norm follows it, so its weights
# are drawn at a tenth (``hbench.core.weights``)
RESIDUAL_LAST = ("attn.proj.", "mlp.fc2.")


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``, with fp8 operands under the control."""
    if lowp.enabled():
        a, b = lowp.q8(a), lowp.q8(b)
    return torch.matmul(a, b)


class Lin(nn.Module):
    """A linear layer's parameters (``weight`` ``[out, in]``, ``bias``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return matmul(x, self.weight.t()) + self.bias


class LN(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, LN_EPS)


def to_nchw(t, H, W):
    B, _, C = t.shape
    return t.transpose(1, 2).reshape(B, C, H, W)


def to_tokens(x):
    B, C, H, W = x.shape
    return x.reshape(B, C, H * W).transpose(1, 2)


def attention(q, k, v):
    """``softmax(q·kᵀ/√d)·v`` over blocks of ``QUERY_BLOCK`` queries."""
    kt = k.transpose(-1, -2) * q.shape[-1] ** -0.5
    return torch.cat([matmul(torch.softmax(matmul(q[:, :, i:i + QUERY_BLOCK], kt), dim=-1), v)
                      for i in range(0, q.shape[2], QUERY_BLOCK)], dim=2)


class Attn(nn.Module):
    def __init__(self, dim: int, heads: int, sr: int):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr
        self.q, self.kv = Lin(dim, dim), Lin(dim, 2 * dim)
        if sr > 1:
            self.sr, self.norm = Conv(dim, dim, sr, bias=True), LN(dim)
        self.proj = Lin(dim, dim)

    def forward(self, x, H, W):
        B, N, C = x.shape
        h, d = self.heads, C // self.heads
        q = self.q(x).reshape(B, N, h, d).transpose(1, 2)
        r = x
        if self.sr_ratio > 1:
            r = to_nchw(x, H, W)
            r = self.norm(to_tokens(conv(r, self.sr.weight, self.sr.bias, self.sr_ratio)))
        kv = self.kv(r).reshape(B, -1, 2, h, d)
        k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
        return self.proj(attention(q, k, v).transpose(1, 2).reshape(B, N, C))


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Lin(dim, hidden)
        self.dwconv = Conv(hidden, hidden, 3, groups=hidden, bias=True)
        self.fc2 = Lin(hidden, dim)

    def forward(self, x, H, W):
        y = to_nchw(self.fc1(x), H, W)
        y = F.gelu(self.dwconv(y, groups=y.shape[1]))
        return self.fc2(to_tokens(y))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, sr: int):
        super().__init__()
        self.norm1, self.attn = LN(dim), Attn(dim, heads, sr)
        self.norm2, self.mlp = LN(dim), MixFFN(dim, 4 * dim)

    def forward(self, x, H, W):
        x = x + self.attn(self.norm1(x), H, W)
        return x + self.mlp(self.norm2(x), H, W)


class PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, kernel: int, stride: int):
        super().__init__()
        self.proj, self.norm, self.stride = Conv(cin, dim, kernel, bias=True), LN(dim), stride

    def forward(self, x):
        x = self.proj(x, stride=self.stride)
        return self.norm(to_tokens(x)), x.shape[2], x.shape[3]


class Backbone(nn.Module):
    def __init__(self, variant: str):
        super().__init__()
        depths, dims = VARIANTS[variant]
        cin = 3
        for s, (depth, dim) in enumerate(zip(depths, dims), start=1):
            kernel, stride = PATCH[s - 1]
            self.add_module(f"patch_embed{s}", PatchEmbed(cin, dim, kernel, stride))
            self.add_module(f"block{s}", nn.ModuleList(
                Block(dim, NUM_HEADS[s - 1], SR_RATIOS[s - 1]) for _ in range(depth)))
            self.add_module(f"norm{s}", LN(dim))
            cin = dim

    def forward(self, x):
        feats = []
        for s in range(1, 5):
            x, H, W = getattr(self, f"patch_embed{s}")(x)
            for block in getattr(self, f"block{s}"):
                x = block(x, H, W)
            x = getattr(self, f"norm{s}")(x)
            feats.append(to_nchw(x, H, W))
            x = feats[-1]
        return feats


class Head(nn.Module):
    def __init__(self, n_classes: int, widths, channels: int, proj: int):
        super().__init__()
        c4 = widths[3]
        self.proj_head = nn.Module()
        self.proj_head.proj = nn.Sequential(Conv(c4, c4, 1), BN(c4), nn.ReLU(), Conv(c4, proj, 1))
        for i, w in enumerate(widths, start=1):
            self.add_module(f"linear_c{i}", Lin(w, channels))
        self.linear_fuse = _cbr(4 * channels, channels)
        self.cls_seg = Conv(channels, n_classes, 1, bias=True)

    def embedding(self, c4):
        p = self.proj_head.proj
        y = p[3](F.relu(p[1](p[0](c4))))
        return y * torch.rsqrt(y.square().sum(dim=1, keepdim=True) + 1e-12)

    def logits(self, feats):
        hw = feats[0].shape[-2:]
        parts = []
        for i, x in enumerate(feats, start=1):
            y = getattr(self, f"linear_c{i}")(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            if y.shape[-2:] != hw:
                y = F.interpolate(y, size=hw, mode="bilinear", align_corners=False)
            parts.append(y)
        f = self.linear_fuse
        y = F.relu(f[1](f[0](torch.cat(parts[::-1], dim=1))))
        return self.cls_seg(y)


class Segmenter(nn.Module):
    """``forward(images NCHW f32, with_train_heads)`` → dict of ``logits``
    ``[B, C, H/4, W/4]`` and, for training, ``embedding`` ``[B, proj,
    H/32, W/32]`` and ``aux_logits`` ``[B, n_fine, H/16, W/16]``."""

    def __init__(self, variant: str, n_classes: int, n_fine: int, channels: int, proj: int):
        super().__init__()
        widths = VARIANTS[variant][1]
        self.backbone = Backbone(variant)
        self.aspp_head = Head(n_classes, widths, channels, proj)
        self.aux_head = nn.Sequential(Conv(widths[2], n_fine, 1), BN(n_fine), nn.ReLU())

    def forward(self, x, with_train_heads: bool = True):
        feats = self.backbone(x)
        out = {"logits": self.aspp_head.logits(feats)}
        if with_train_heads:
            out["embedding"] = self.aspp_head.embedding(feats[3])
            a = self.aux_head
            out["aux_logits"] = F.relu(a[1](a[0](feats[2])))
        return out


def build(model_cfg: Dict, tree) -> Segmenter:
    """The reference model of a config's ``model`` section (``backbone:
    mit``, ``head: segformer_mlp``), on the meta device, and its label
    tree."""
    if model_cfg.get("backbone") != "mit" or model_cfg.get("head") != "segformer_mlp":
        raise ValueError("reference/mit.py builds model.backbone: mit with head: segformer_mlp")
    bb = model_cfg.get("backbone_options") or {}
    hd = model_cfg.get("head_options") or {}
    if float(bb.get("drop_path_rate", 0.0)) or float(hd.get("dropout_rate", 0.1)):
        raise ValueError("the reference runs no drop path or dropout: set "
                         "backbone_options.drop_path_rate and head_options.dropout_rate to 0")
    with torch.device("meta"):
        return Segmenter(str(bb.get("variant", "b0")), tree.total, tree.n_fine,
                         int(hd.get("channels", 256)), int(model_cfg.get("proj_dim", 256)))
