"""Assembled hierarchical segmenter = backbone + decode head + aux head
(the port of ``seghiero_tpu/models/segmenter.py``).

Top-level submodules are named after the reference checkpoint's three
state dicts: ``backbone``, ``aspp_head`` (whatever the decode head is)
and ``aux_head``. A backbone gives its four stage widths as ``widths``.
Registered here: the backbones ``resnet`` (ResNet-18 to 152), ``mit``
(MiT-B0 to B5), ``swin`` (Swin tiny to large) and ``vit`` (ViT tiny to
large with the simple feature pyramid), and the heads
``sep_aspp_contrast``, ``segformer_mlp`` and ``upernet``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from seghiero_torch import trace
from seghiero_torch.config import SegHieroConfig
from seghiero_torch.models.heads import (
    AuxHead,
    SegFormerMLPHead,
    SepASPPContrastHead,
    UPerNetHead,
)
from seghiero_torch.models.mit import MiTBackbone
from seghiero_torch.models.registry import (
    backbone_builder,
    head_builder,
    register_backbone,
    register_head,
)
from seghiero_torch.models.resnet import ResNetBackbone
from seghiero_torch.models.swin import SwinBackbone, WindowAttention
from seghiero_torch.models.vit import ViTBackbone

ALL_OUTPUTS = ("logits", "embedding", "aux_logits")


class HieroSegmenter(nn.Module):
    """forward(images NCHW, outputs) → dict with the requested entries:
      - ``logits``     [B, num_classes, H/4, W/4] f32 (fine|coarse|super)
      - ``embedding``  [B, proj_dim, H/32, W/32] f32, L2-normalized
      - ``aux_logits`` [B, n_fine, H/16, W/16] f32

    Asking only for what is consumed matters in eager PyTorch: the
    predictor asks for ``("logits",)`` and the projection and aux heads do
    not run. The input is cast to the dtype of the backbone's first
    parameter (its stem), so a model whose convolutions and linear layers
    were cast to bf16 computes in bf16. The spans ``model.backbone`` and
    ``model.head`` (the decode and aux heads) time the two halves."""

    def __init__(self, backbone: nn.Module, head: nn.Module, aux_head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.aspp_head = head
        self.aux_head = aux_head

    def forward(self, images: torch.Tensor, outputs: Sequence[str] = ALL_OUTPUTS
                ) -> Dict[str, torch.Tensor]:
        unknown = set(outputs) - set(ALL_OUTPUTS)
        if unknown:
            raise ValueError(f"unknown outputs {sorted(unknown)}; choose from {ALL_OUTPUTS}")
        with trace.span("model.backbone"):
            feats = self.backbone(images.to(next(self.backbone.parameters()).dtype))
        with trace.span("model.head"):
            logits, embedding = self.aspp_head(feats, outputs)
            out = {}
            if logits is not None:
                out["logits"] = logits
            if embedding is not None:
                out["embedding"] = embedding
            if "aux_logits" in outputs:
                out["aux_logits"] = self.aux_head(feats[2])
        return out


@register_backbone("resnet")
def _build_resnet(cfg: SegHieroConfig) -> nn.Module:
    return ResNetBackbone(cfg.model.depth, cfg.model.output_stride)


@register_backbone("mit")
def _build_mit(cfg: SegHieroConfig) -> nn.Module:
    opts = cfg.model.backbone_options or {}
    return MiTBackbone(str(opts.get("variant", "b0")), float(opts.get("drop_path_rate", 0.0)),
                       dw_kernel=cfg.model.depthwise_backend == "pallas")


@register_backbone("swin")
def _build_swin(cfg: SegHieroConfig) -> nn.Module:
    opts = cfg.model.backbone_options or {}
    return SwinBackbone(str(opts.get("variant", "tiny")), int(opts.get("window", 7)),
                        float(opts.get("drop_path_rate", 0.0)))


@register_backbone("vit")
def _build_vit(cfg: SegHieroConfig) -> nn.Module:
    opts = cfg.model.backbone_options or {}
    return ViTBackbone(str(opts.get("variant", "base")), int(opts.get("patch", 16)),
                       int(opts.get("pos_grid", 0)), float(opts.get("drop_path_rate", 0.0)),
                       float(opts.get("layer_scale_init", 0.0)), int(opts.get("n_register", 0)),
                       float(opts.get("norm_eps", 1e-6)))


@register_head("sep_aspp_contrast")
def _build_sep_aspp_contrast(cfg: SegHieroConfig, widths) -> nn.Module:
    m = cfg.model
    return SepASPPContrastHead(
        num_classes=cfg.hierarchy.total_classes,
        in_channels=widths[3],
        c1_in_channels=widths[0],
        c1_channels=m.c1_channels,
        aspp_channels=m.aspp_channels,
        dilations=tuple(m.dilations),
        proj_dim=m.proj_dim,
        proj_type=m.proj_type,
        dw_kernel=m.depthwise_backend == "pallas",
    )


@register_head("segformer_mlp")
def _build_segformer_mlp(cfg: SegHieroConfig, widths) -> nn.Module:
    m, opts = cfg.model, cfg.model.head_options or {}
    return SegFormerMLPHead(
        num_classes=cfg.hierarchy.total_classes,
        widths=widths,
        channels=int(opts.get("channels", 256)),
        dropout_rate=float(opts.get("dropout_rate", 0.1)),
        proj_dim=m.proj_dim,
        proj_type=m.proj_type,
    )


@register_head("upernet")
def _build_upernet(cfg: SegHieroConfig, widths) -> nn.Module:
    m, opts = cfg.model, cfg.model.head_options or {}
    return UPerNetHead(
        num_classes=cfg.hierarchy.total_classes,
        widths=widths,
        channels=int(opts.get("channels", 512)),
        pool_scales=tuple(opts.get("pool_scales", (1, 2, 3, 6))),
        dropout_rate=float(opts.get("dropout_rate", 0.1)),
        proj_dim=m.proj_dim,
        proj_type=m.proj_type,
    )


def seeded_init_(model: nn.Module, seed: int) -> nn.Module:
    """Initialize like the JAX package's flax modules, from ``seed``:
    conv, deconvolution and linear kernels lecun-normal (a normal truncated
    at ±2σ, rescaled so the standard deviation is 1/√fan_in), their biases
    0, BatchNorm and LayerNorm scale 1 and shift 0, Swin's
    relative-position tables a normal of std 0.02 truncated at ±2σ, ViT's
    CLS, register and position tokens a normal of std 0.02. (The draws
    differ from JAX's: tests carry weights across.)"""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                fan_in = mod.weight[0].numel()
                if isinstance(mod, nn.ConvTranspose2d):  # weight [in, out, kh, kw]
                    fan_in = mod.weight.shape[0] * mod.weight[0, 0].numel()
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.BatchNorm2d, nn.LayerNorm)):
                mod.reset_parameters()
            elif isinstance(mod, WindowAttention):
                nn.init.trunc_normal_(mod.relative_position_bias_table, 0.0, 0.02, -0.04, 0.04,
                                      generator=gen)
            elif isinstance(mod, ViTBackbone):
                for p in (mod.cls_token, mod.reg_token, mod.pos_embed):
                    if p is not None:
                        nn.init.normal_(p, 0.0, 0.02, generator=gen)
    return model


def build_model(cfg: SegHieroConfig) -> HieroSegmenter:
    """f32 model on the CPU from a validated config. The aux head is always
    built, so reference checkpoints load strictly; serving never runs it."""
    backbone = backbone_builder(cfg.model.backbone)(cfg)
    head = head_builder(cfg.model.head)(cfg, backbone.widths)
    return HieroSegmenter(backbone, head, AuxHead(backbone.widths[2], cfg.hierarchy.n_fine))

