"""The plain float32 reference of ViT + UperNet: the plain Vision
Transformer (tiny to large; Dosovitskiy et al., arXiv:2010.11929) with
ViTDet's simple feature pyramid (Li et al., arXiv:2203.16527 §3), UperNet's
pyramid pooling and FPN head (``reference/swin.py``'s), its contrastive
projection on C4 and the aux head on C3, written in plain
``torch.nn.functional`` calls. It imports nothing of the program.

* The position table's grid is resized to the input's by the
  cubic-convolution matrices written out here (A = −0.75, half-pixel
  centres, the taps past a border clamped onto it: ``F.interpolate``'s
  bicubic), rows then columns; the CLS slot is kept, register tokens take
  no position.
* Attention is two matrix products with the whole ``[B, h, N, N]`` score
  matrix and an f32 softmax between them, so ``core/flops.py`` counts the
  products. At 4 097 tokens a block's scores are 1.07 GB, so each block
  recomputes its forward in its backward (``torch.utils.checkpoint``),
  which changes no arithmetic; on the meta device (``core/flops.py``,
  ``core/geometry.py``) the blocks run once, so the forward is counted once.
* Each 2×2/2 deconvolution of the pyramid is one matrix product of the
  NHWC map with the ``[in, out·4]`` kernel, its outputs spread to their
  2×2 cells.
* UperNet's pyramid pooling on a batch of one image leaves its 1×1
  pool one value a channel, which ``F.batch_norm`` refuses in train mode;
  there the pooling branches normalize by hand: the value is its own mean
  at variance 0, so the branch gives its BatchNorm's shift.
* Under the control (``lowp.enabled``) every matrix product and
  convolution takes fp8 operands (``lowp.q8``).

Module and parameter names are the program's (``backbone.blocks.{i}.attn.
qkv``, ``backbone.fpn1.0``, ``aspp_head.fpn_bottleneck.1``, ...), so one
state dict made by ``hbench.core.weights`` loads into both. The CLS,
register and position tokens are held flat (their state dict entries
have the program's ``[1, n, D]`` shapes), so that ``reference/train.py``'s
``param_setting``, which decays parameters of two or more dimensions
under ``wd_skip_norm_bias``, leaves them undecayed, as the program's
groups and mmseg's ``decay_mult=0`` do. Drop path and dropout draw random
masks no comparison could match: ``build`` refuses them.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from hbench.reference.mit import matmul
from hbench.reference.model import BN, BN_EPS, Conv, conv
from hbench.reference import swin
from hbench.reference.swin import Lin, _run

VARIANTS = {
    "tiny": (192, 12, 3),
    "small": (384, 12, 6),
    "base": (768, 12, 12),
    "large": (1024, 24, 16),
}
# each residual branch's last layer: no norm follows it, so its weights
# are drawn at a tenth (``hbench.core.weights``)
RESIDUAL_LAST = ("attn.proj.", "mlp.fc2.")


def cubic_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """``[n_out, n_in]``: output ``i`` reads the input at ``(i + ½)·n_in/n_out
    − ½`` through the four taps of the cubic-convolution kernel
    ``W(x) = (A+2)|x|³ − (A+3)|x|² + 1`` for ``|x| ≤ 1``, ``A|x|³ − 5A|x|² +
    8A|x| − 4A`` for ``1 < |x| < 2``, A = −0.75, each tap's index clamped
    to ``[0, n_in)``."""
    A = -0.75

    def kernel(x):
        x = abs(x)
        if x <= 1:
            return (A + 2) * x ** 3 - (A + 3) * x ** 2 + 1
        return A * x ** 3 - 5 * A * x ** 2 + 8 * A * x - 4 * A if x < 2 else 0.0

    m = torch.zeros(n_out, n_in, dtype=torch.float64)
    for i in range(n_out):
        src = (i + 0.5) * n_in / n_out - 0.5
        base = math.floor(src)
        for j in range(base - 1, base + 3):
            m[i, min(max(j, 0), n_in - 1)] += kernel(src - j)
    return m.float().to(device)


def resize_table(pos: torch.Tensor, grid: int, hw) -> torch.Tensor:
    """``[1, 1 + grid², D]`` → ``[1, 1 + h·w, D]``."""
    h, w = hw
    if (grid, grid) == (h, w):
        return pos
    p = pos[0, 1:].reshape(grid, grid, -1)
    p = torch.einsum("Hh,hwd->Hwd", cubic_matrix(grid, h, pos.device), p)
    p = torch.einsum("Ww,hwd->hWd", cubic_matrix(grid, w, pos.device), p)
    return torch.cat([pos[:, :1], p.reshape(1, h * w, -1)], dim=1)


def attention(q, k, v):
    """``softmax(q·kᵀ/√d)·v``, ``q, k, v [B, h, N, d]``."""
    scores = matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    return matmul(torch.softmax(scores, dim=-1), v)


def deconv2x2(x, weight, bias):
    """A 2×2/2 deconvolution of NHWC ``x`` with ``weight [in, out, 2, 2]``:
    output ``(2i + a, 2j + b)`` is ``Σ_c x[i, j, c]·weight[c, :, a, b]``."""
    B, h, w, cin = x.shape
    cout = weight.shape[1]
    y = matmul(x, weight.reshape(cin, cout * 4)).reshape(B, h, w, cout, 2, 2)
    return y.permute(0, 1, 4, 2, 5, 3).reshape(B, 2 * h, 2 * w, cout) + bias


class PoolBN(BN):
    """``BN`` that also takes one value a channel in train mode:
    ``(x − mean) / √(var + eps)·weight + bias`` with the batch's mean and
    biased variance, written out."""

    def forward(self, x):
        if not self.training or x.numel() > x.shape[1]:
            return super().forward(x)
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        var = (x - mean).square().mean(dim=(0, 2, 3), keepdim=True)
        shape = (1, -1, 1, 1)
        return (x - mean) / torch.sqrt(var + BN_EPS) * self.weight.view(shape) + \
            self.bias.view(shape)


class Head(swin.Head):
    """UperNet (``reference/swin.py``'s), its pooling branches' BatchNorms
    taking one value a channel."""

    def __init__(self, n_classes: int, widths, channels: int, pool_scales, proj: int):
        super().__init__(n_classes, widths, channels, pool_scales, proj)
        for m in self.psp_modules:
            m[1] = PoolBN(channels)


class LN(nn.Module):
    def __init__(self, c: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)


class Gamma(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(c))


class Deconv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 2, 2))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return deconv2x2(x, self.weight, self.bias)


class Attn(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv, self.proj = Lin(dim, 3 * dim), Lin(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.heads, C // self.heads).permute(2, 0, 3, 1, 4)
        y = attention(qkv[0], qkv[1], qkv[2])
        return self.proj(y.transpose(1, 2).reshape(B, N, C))


class Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1, self.fc2 = Lin(dim, 4 * dim), Lin(4 * dim, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, layer_scale: bool, eps: float):
        super().__init__()
        self.norm1, self.attn = LN(dim, eps), Attn(dim, heads)
        self.norm2, self.mlp = LN(dim, eps), Mlp(dim)
        if layer_scale:
            self.ls1, self.ls2 = Gamma(dim), Gamma(dim)
        self.layer_scale = layer_scale

    def forward(self, x):
        y = self.attn(self.norm1(x))
        x = x + (y * self.ls1.gamma if self.layer_scale else y)
        y = self.mlp(self.norm2(x))
        return x + (y * self.ls2.gamma if self.layer_scale else y)


class Backbone(nn.Module):
    def __init__(self, variant: str, patch: int, pos_grid: int, n_register: int,
                 layer_scale: bool, eps: float):
        super().__init__()
        dim, depth, heads = VARIANTS[variant]
        self.patch, self.n_register, self.eps = patch, n_register, eps
        self.grid = pos_grid or 224 // patch
        self.patch_embed = nn.Module()
        self.patch_embed.proj = Conv(3, dim, patch, bias=True)
        self.token_shapes = {"cls_token": (1, 1, dim), "pos_embed": (1, 1 + self.grid ** 2, dim)}
        if n_register:
            self.token_shapes["reg_token"] = (1, n_register, dim)
        for k, shape in self.token_shapes.items():
            setattr(self, k, nn.Parameter(torch.empty(math.prod(shape))))
        self._register_state_dict_hook(self._tokens_shaped)
        self._register_load_state_dict_pre_hook(self._tokens_flat)
        self.blocks = nn.ModuleList(Block(dim, heads, layer_scale, eps) for _ in range(depth))
        self.norm = LN(dim, eps)
        # NHWC in and out
        self.fpn1 = nn.Sequential(Deconv(dim, dim // 2), LN(dim // 2, eps), nn.GELU(),
                                  Deconv(dim // 2, dim // 4))
        self.fpn2 = nn.Sequential(Deconv(dim, dim // 2))

    @staticmethod
    def _tokens_shaped(module, sd, prefix, _meta):
        for k, shape in module.token_shapes.items():
            sd[prefix + k] = sd[prefix + k].reshape(shape)

    def _tokens_flat(self, sd, prefix, *_):
        for k in self.token_shapes:
            if prefix + k in sd:
                sd[prefix + k] = sd[prefix + k].reshape(-1)

    def token(self, k):
        return getattr(self, k).reshape(self.token_shapes[k])

    def forward(self, x):
        pe = self.patch_embed.proj
        x = conv(x, pe.weight, pe.bias, stride=self.patch)
        B, D, h, w = x.shape
        pos = resize_table(self.token("pos_embed"), self.grid, (h, w))
        tok = x.flatten(2).transpose(1, 2) + pos[:, 1:]
        extras = [(self.token("cls_token") + pos[:, :1]).expand(B, -1, -1)]
        if self.n_register:
            extras.append(self.token("reg_token").expand(B, -1, -1))
        tok = torch.cat(extras + [tok], dim=1)
        recompute = torch.is_grad_enabled() and not tok.is_meta
        for block in self.blocks:
            tok = checkpoint(block, tok, use_reentrant=False) if recompute else block(tok)
        feat = self.norm(tok)[:, 1 + self.n_register:].reshape(B, h, w, D)
        c3 = feat.permute(0, 3, 1, 2)
        return [self.fpn1(feat).permute(0, 3, 1, 2), self.fpn2(feat).permute(0, 3, 1, 2), c3,
                F.max_pool2d(c3, 2, 2)]


class Segmenter(nn.Module):
    """``forward(images NCHW f32, with_train_heads)`` → dict of ``logits``
    ``[B, C, H/4, W/4]`` and, for training, ``embedding`` ``[B, proj,
    H/32, W/32]`` and ``aux_logits`` ``[B, n_fine, H/16, W/16]``."""

    def __init__(self, bb: Dict, n_classes: int, n_fine: int, channels: int, pool_scales,
                 proj: int):
        super().__init__()
        dim = VARIANTS[bb["variant"]][0]
        widths = (dim // 4, dim // 2, dim, dim)
        self.backbone = Backbone(**bb)
        self.aspp_head = Head(n_classes, widths, channels, pool_scales, proj)
        self.aux_head = nn.Sequential(Conv(widths[2], n_fine, 1), BN(n_fine), nn.ReLU())

    def forward(self, x, with_train_heads: bool = True):
        feats = self.backbone(x)
        out = {"logits": self.aspp_head.logits(feats)}
        if with_train_heads:
            out["embedding"] = self.aspp_head.embedding(feats[3])
            out["aux_logits"] = _run(self.aux_head, feats[2])
        return out


def build(model_cfg: Dict, tree) -> Segmenter:
    """The reference model of a config's ``model`` section (``backbone:
    vit``, ``head: upernet``), on the meta device, and its label tree."""
    if model_cfg.get("backbone") != "vit" or model_cfg.get("head") != "upernet":
        raise ValueError("reference/vit.py builds model.backbone: vit with head: upernet")
    bb = model_cfg.get("backbone_options") or {}
    hd = model_cfg.get("head_options") or {}
    if float(bb.get("drop_path_rate", 0.0)) or float(hd.get("dropout_rate", 0.1)):
        raise ValueError("the reference runs no drop path or dropout: set "
                         "backbone_options.drop_path_rate and head_options.dropout_rate to 0")
    opts = {"variant": str(bb.get("variant", "base")), "patch": int(bb.get("patch", 16)),
            "pos_grid": int(bb.get("pos_grid", 0)), "n_register": int(bb.get("n_register", 0)),
            "layer_scale": bool(float(bb.get("layer_scale_init", 0.0))),
            "eps": float(bb.get("norm_eps", 1e-6))}
    with torch.device("meta"):
        return Segmenter(opts, tree.total, tree.n_fine, int(hd.get("channels", 512)),
                         tuple(hd.get("pool_scales", (1, 2, 3, 6))),
                         int(model_cfg.get("proj_dim", 256)))
