"""Assembled hierarchical segmenter = backbone + decode head + aux head
(the port of ``seghiero_tpu/models/segmenter.py``).

Top-level submodules are named after the reference checkpoint's three
state dicts: ``backbone``, ``aspp_head`` and ``aux_head``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from seghiero_torch.config import SegHieroConfig
from seghiero_torch.models.heads import AuxHead, SepASPPContrastHead
from seghiero_torch.models.registry import (
    backbone_builder,
    head_builder,
    register_backbone,
    register_head,
)
from seghiero_torch.models.resnet import ResNetBackbone

ALL_OUTPUTS = ("logits", "embedding", "aux_logits")


class HieroSegmenter(nn.Module):
    """forward(images NCHW, outputs) → dict with the requested entries:
      - ``logits``     [B, num_classes, H/4, W/4] f32 (fine|coarse|super)
      - ``embedding``  [B, proj_dim, H/32, W/32] f32, L2-normalized
      - ``aux_logits`` [B, n_fine, H/16, W/16] f32

    Asking only for what is consumed matters in eager PyTorch: the
    predictor asks for ``("logits",)`` and the projection and aux heads do
    not run. The input is cast to the dtype of the stem's weight, so a
    model whose convolutions were cast to bf16 computes in bf16."""

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
        feats = self.backbone(images.to(self.backbone.stem_conv.weight.dtype))
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


def build_model(cfg: SegHieroConfig) -> HieroSegmenter:
    """f32 model on the CPU from a validated config. The aux head is always
    built, so reference checkpoints load strictly; serving never runs it."""
    backbone = backbone_builder(cfg.model.backbone)(cfg)
    widths = ResNetBackbone.stage_channels(cfg.model.depth)
    head = head_builder(cfg.model.head)(cfg, widths)
    return HieroSegmenter(backbone, head, AuxHead(widths[2], cfg.hierarchy.n_fine))

