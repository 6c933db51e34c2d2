"""The plain float32 reference of Swin + UperNet: the Swin Transformer
encoder (tiny to large; Liu et al., arXiv:2103.14030) with UperNet's
pyramid pooling and FPN head (Xiao et al., arXiv:1807.10221), its
contrastive projection on C4 and the aux head on C3, written in plain
``torch.nn.functional`` calls. It imports nothing of the program.

* Window attention is two matrix products with the gathered
  relative-position bias, the shift's region mask (−100 across regions)
  and a softmax between them, so ``core/flops.py`` counts the products.
  The relative-position index and the masks are made in each forward pass
  on the input's device (the meta device included).
* Maps are zero-padded to window multiples, rolled by −w/2 in the shifted
  blocks, and every stage partitions, however small its map (the
  always-partition semantics of HF ``SwinBackbone`` and mmseg).
* Under the control (``lowp.enabled``) every matrix product and
  convolution takes fp8 operands (``lowp.q8``).

Module and parameter names are the program's (``backbone.layers.{s}.
blocks.{j}.attn.qkv``, ``aspp_head.fpn_bottleneck.1``, ...), so one state
dict made by ``hbench.core.weights`` loads into both. Each relative-position
table is held flat (its state dict entry has the program's
``[(2w−1)², heads]`` shape), so that ``reference/train.py``'s
``param_setting``, which decays parameters of two or more dimensions under
``wd_skip_norm_bias``, leaves it undecayed, as the program's groups and
mmseg's ``decay_mult=0`` do. Drop path and dropout draw random masks no
comparison could match: ``build`` refuses them.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from hbench.reference.mit import matmul
from hbench.reference.model import BN, Conv, _cbr, conv

VARIANTS = {
    "tiny": (96, (2, 2, 6, 2), (3, 6, 12, 24)),
    "small": (96, (2, 2, 18, 2), (3, 6, 12, 24)),
    "base": (128, (2, 2, 18, 2), (4, 8, 16, 32)),
    "large": (192, (2, 2, 18, 2), (6, 12, 24, 48)),
}
LN_EPS = 1e-5
# each residual branch's last layer: no norm follows it, so its weights
# are drawn at a tenth (``hbench.core.weights``)
RESIDUAL_LAST = ("attn.proj.", "mlp.fc2.")


class Lin(nn.Module):
    """A linear layer's parameters (``weight`` ``[out, in]``, ``bias``)."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        y = matmul(x, self.weight.t())
        return y if self.bias is None else y + self.bias


class LN(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, LN_EPS)


def rel_index(w: int, device) -> torch.Tensor:
    """``[w²·w²]`` index into the ``(2w−1)²`` table, row-major offsets."""
    ys, xs = torch.meshgrid(torch.arange(w, device=device), torch.arange(w, device=device),
                            indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    dy, dx = ys[:, None] - ys[None, :] + w - 1, xs[:, None] - xs[None, :] + w - 1
    return (dy * (2 * w - 1) + dx).reshape(-1)


def partition(x, w):
    """``[B, H, W, C]`` → ``[B·nW, w², C]``."""
    B, H, W, C = x.shape
    return x.reshape(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, C)


def unpartition(win, w, B, H, W):
    C = win.shape[-1]
    return win.reshape(B, H // w, W // w, w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def region_mask(hp, wp, w, s, device) -> torch.Tensor:
    """``[nW, w², w²]``: 0 within a region of the rolled map, −100 across."""
    img = torch.zeros(hp, wp, device=device)
    cuts = (slice(0, hp - w), slice(hp - w, hp - s), slice(hp - s, hp))
    cols = (slice(0, wp - w), slice(wp - w, wp - s), slice(wp - s, wp))
    for i, hs in enumerate(cuts):
        for j, ws in enumerate(cols):
            img[hs, ws] = 3 * i + j
    win = partition(img[None, :, :, None], w)[..., 0]
    return (win[:, None, :] != win[:, :, None]).float() * -100.0


def window_attention(q, k, v, bias):
    """``softmax(q·kᵀ/√d + bias)·v``, ``q, k, v [B·nW, h, N, d]``."""
    scores = matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5 + bias
    return matmul(torch.softmax(scores, dim=-1), v)


class Attn(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.window = heads, window
        self.qkv, self.proj = Lin(dim, 3 * dim), Lin(dim, dim)
        self.table_shape = ((2 * window - 1) ** 2, heads)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty(self.table_shape[0] * heads))
        self._register_state_dict_hook(self._table_2d)
        self._register_load_state_dict_pre_hook(self._table_flat)

    @staticmethod
    def _table_2d(module, sd, prefix, _meta):
        k = prefix + "relative_position_bias_table"
        sd[k] = sd[k].reshape(module.table_shape)

    def _table_flat(self, sd, prefix, *_):
        k = prefix + "relative_position_bias_table"
        if k in sd:
            sd[k] = sd[k].reshape(-1)

    def forward(self, x, mask):
        Bw, N, C = x.shape
        h, d = self.heads, C // self.heads
        qkv = self.qkv(x).reshape(Bw, N, 3, h, d).permute(2, 0, 3, 1, 4)
        table = self.relative_position_bias_table.reshape(self.table_shape)
        bias = table[rel_index(self.window, x.device)].reshape(N, N, h).permute(2, 0, 1)
        bias = bias[None]
        if mask is not None:
            nW = mask.shape[0]
            bias = (bias + mask[:, None]).repeat(Bw // nW, 1, 1, 1)
        y = window_attention(qkv[0], qkv[1], qkv[2], bias)
        return self.proj(y.transpose(1, 2).reshape(Bw, N, C))


class Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1, self.fc2 = Lin(dim, 4 * dim), Lin(4 * dim, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int):
        super().__init__()
        self.norm1, self.attn = LN(dim), Attn(dim, heads, window)
        self.norm2, self.mlp = LN(dim), Mlp(dim)
        self.window, self.shift = window, shift

    def forward(self, x):
        B, H, W, _ = x.shape
        w, s = self.window, self.shift
        ph, pw = (-H) % w, (-W) % w
        y = F.pad(self.norm1(x), (0, 0, 0, pw, 0, ph))
        Hp, Wp = H + ph, W + pw
        mask = None
        if s:
            y = torch.roll(y, (-s, -s), (1, 2))
            mask = region_mask(Hp, Wp, w, s, x.device)
        y = unpartition(self.attn(partition(y, w), mask), w, B, Hp, Wp)
        if s:
            y = torch.roll(y, (s, s), (1, 2))
        x = x + y[:, :H, :W]
        return x + self.mlp(self.norm2(x))


class Merge(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm, self.reduction = LN(4 * dim), Lin(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        H, W = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class Backbone(nn.Module):
    def __init__(self, variant: str, window: int):
        super().__init__()
        dim, depths, heads = VARIANTS[variant]
        self.patch_embed = nn.Module()
        self.patch_embed.proj, self.patch_embed.norm = Conv(3, dim, 4, bias=True), LN(dim)
        self.layers = nn.ModuleList()
        for s, (depth, h) in enumerate(zip(depths, heads)):
            layer = nn.Module()
            layer.blocks = nn.ModuleList(
                Block(dim << s, h, window, 0 if j % 2 == 0 else window // 2)
                for j in range(depth))
            if s < 3:
                layer.downsample = Merge(dim << s)
            self.layers.append(layer)
            self.add_module(f"norm{s}", LN(dim << s))

    def forward(self, x):
        ph, pw = (-x.shape[2]) % 4, (-x.shape[3]) % 4
        x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        pe = self.patch_embed
        x = pe.norm(conv(x, pe.proj.weight, pe.proj.bias, stride=4).permute(0, 2, 3, 1))
        feats = []
        for s, layer in enumerate(self.layers):
            for block in layer.blocks:
                x = block(x)
            feats.append(getattr(self, f"norm{s}")(x).permute(0, 3, 1, 2))
            if s < 3:
                x = layer.downsample(x)
        return feats


def _cbr3(cin, cout):
    return nn.Sequential(Conv(cin, cout, 3), BN(cout), nn.ReLU())


def _run(seq, x):
    return F.relu(seq[1](seq[0](x)))


def _up(x, hw):
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=False)


class Head(nn.Module):
    def __init__(self, n_classes: int, widths, channels: int, pool_scales, proj: int):
        super().__init__()
        c4 = widths[3]
        self.pool_scales = tuple(pool_scales)
        self.proj_head = nn.Module()
        self.proj_head.proj = nn.Sequential(Conv(c4, c4, 1), BN(c4), nn.ReLU(), Conv(c4, proj, 1))
        self.psp_modules = nn.ModuleList(_cbr(c4, channels) for _ in self.pool_scales)
        self.bottleneck = _cbr3(c4 + len(self.pool_scales) * channels, channels)
        self.lateral_convs = nn.ModuleList(_cbr(w, channels) for w in widths[:3])
        self.fpn_convs = nn.ModuleList(_cbr3(channels, channels) for _ in range(3))
        self.fpn_bottleneck = _cbr3(4 * channels, channels)
        self.cls_seg = Conv(channels, n_classes, 1, bias=True)

    def embedding(self, c4):
        p = self.proj_head.proj
        y = p[3](F.relu(p[1](p[0](c4))))
        return y * torch.rsqrt(y.square().sum(dim=1, keepdim=True) + 1e-12)

    def logits(self, feats):
        c1, c2, c3, c4 = feats
        psp = [c4] + [_up(_run(m, F.adaptive_avg_pool2d(c4, s)), c4.shape[-2:])
                      for s, m in zip(self.pool_scales, self.psp_modules)]
        lat = [_run(m, x) for m, x in zip(self.lateral_convs, (c1, c2, c3))]
        lat.append(_run(self.bottleneck, torch.cat(psp, dim=1)))
        for i in (2, 1, 0):
            lat[i] = lat[i] + _up(lat[i + 1], lat[i].shape[-2:])
        outs = [_run(m, x) for m, x in zip(self.fpn_convs, lat[:3])] + [lat[3]]
        outs = [_up(o, c1.shape[-2:]) for o in outs]
        return self.cls_seg(_run(self.fpn_bottleneck, torch.cat(outs, dim=1)))


class Segmenter(nn.Module):
    """``forward(images NCHW f32, with_train_heads)`` → dict of ``logits``
    ``[B, C, H/4, W/4]`` and, for training, ``embedding`` ``[B, proj,
    H/32, W/32]`` and ``aux_logits`` ``[B, n_fine, H/16, W/16]``."""

    def __init__(self, variant: str, window: int, n_classes: int, n_fine: int, channels: int,
                 pool_scales, proj: int):
        super().__init__()
        dim = VARIANTS[variant][0]
        widths = (dim, 2 * dim, 4 * dim, 8 * dim)
        self.backbone = Backbone(variant, window)
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
    swin``, ``head: upernet``), on the meta device, and its label tree."""
    if model_cfg.get("backbone") != "swin" or model_cfg.get("head") != "upernet":
        raise ValueError("reference/swin.py builds model.backbone: swin with head: upernet")
    bb = model_cfg.get("backbone_options") or {}
    hd = model_cfg.get("head_options") or {}
    if float(bb.get("drop_path_rate", 0.0)) or float(hd.get("dropout_rate", 0.1)):
        raise ValueError("the reference runs no drop path or dropout: set "
                         "backbone_options.drop_path_rate and head_options.dropout_rate to 0")
    with torch.device("meta"):
        return Segmenter(str(bb.get("variant", "tiny")), int(bb.get("window", 7)), tree.total,
                         tree.n_fine, int(hd.get("channels", 512)),
                         tuple(hd.get("pool_scales", (1, 2, 3, 6))),
                         int(model_cfg.get("proj_dim", 256)))
