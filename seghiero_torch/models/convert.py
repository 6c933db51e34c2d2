"""Weights carried across from the JAX package.

``export_reference_checkpoint`` takes a JAX ``HieroSegmenter`` variables
tree (``{"params": ..., "batch_stats": ...}``, leaves as numpy arrays)
and returns the reference checkpoint dict — ``backbone_state_dict``,
``aspp_head_state_dict``, ``aux_head_state_dict`` — of torch tensors,
the layout ``seghiero_tpu/models/torch_convert.py`` writes and the
original SegHiero saves. It is the port's own copy of that logic:

* conv kernels HWIO → OIHW (the depthwise ``[3, 3, 1, C]`` → ``[C, 1, 3, 3]``
  is the same transpose);
* BatchNorm ``scale / bias / mean / var`` → ``weight / bias /
  running_mean / running_var`` (+ ``num_batches_tracked``);
* the classifier's bias, the only conv bias in the model.

A MiT backbone with the SegFormer head (``backbone: mit``, ``head:
segformer_mlp``) goes through ``mit_backbone_state_dict`` and
``segformer_head_state_dict``: dense kernels ``[in, out]`` → linear
weights ``[out, in]``, LayerNorm ``scale / bias`` → ``weight / bias``,
every conv bias, and the JAX package's separate ``k`` and ``v`` joined
into the port's ``kv`` (``k`` first). A Swin backbone with UperNet
(``backbone: swin``, ``head: upernet``) goes through
``swin_backbone_state_dict`` and ``upernet_head_state_dict``: the same
dense and LayerNorm rules, ``q``, ``k`` and ``v`` joined into the
official release's fused ``qkv`` (in that order), ``rel_bias_table``
renamed ``relative_position_bias_table``, each stage's ``merge{s}`` at
the end of the stage before it (``layers.{s-1}.downsample``), and the
head's BatchNorm statistics from the JAX ``batch_stats``. A ViT backbone
with UperNet (``backbone: vit``) goes through ``vit_backbone_state_dict``
and the same head: the dense and LayerNorm rules, ``block{i}`` renamed
``blocks.{i}`` with timm's ``mlp.fc1`` / ``mlp.fc2`` and ``ls{1,2}.gamma``,
``reg_tokens`` renamed ``reg_token``, and the pyramid's deconvolution
kernels ``[kh, kw, in, out]`` → ``[in, out, kh, kw]`` with both spatial
axes flipped (flax's ``ConvTranspose`` does not flip the kernel; PyTorch's
is the convolution's gradient, which does).

``load_reference_checkpoint`` loads such a dict into the port's model,
each part with ``strict=True``.

``import_torchvision_backbone`` takes a torchvision ResNet state dict
(``model.pretrained: <path>``, read by ``load_torch_file``) to the
backbone's own names, and ``load_pretrained_backbone`` loads it.
"""

from __future__ import annotations

import pickle
import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from seghiero_torch.models import swin, vit
from seghiero_torch.models.mit import VARIANTS
from seghiero_torch.models.resnet import BOTTLENECK_DEPTHS, STAGE_BLOCKS

PARTS = {
    "backbone_state_dict": "backbone",
    "aspp_head_state_dict": "aspp_head",
    "aux_head_state_dict": "aux_head",
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _conv(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def _bn(sd: Dict, prefix: str, params: Mapping, stats: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def _sepconv(sd: Dict, dst: str, params: Mapping, stats: Mapping) -> None:
    sd[f"{dst}.depthwise.weight"] = _conv(params["depthwise"]["kernel"])
    _bn(sd, f"{dst}.bn_dw", params["bn_dw"], stats["bn_dw"])
    sd[f"{dst}.pointwise.weight"] = _conv(params["pointwise"]["kernel"])
    _bn(sd, f"{dst}.bn_pw", params["bn_pw"], stats["bn_pw"])


def backbone_state_dict(params: Mapping, stats: Mapping, depth: int) -> Dict:
    sd: Dict = {"stem_conv.weight": _conv(params["stem_conv"]["kernel"])}
    _bn(sd, "stem_bn", params["stem_bn"], stats["stem_bn"])
    n_convs = 3 if depth in BOTTLENECK_DEPTHS else 2
    for stage, n_blocks in enumerate(STAGE_BLOCKS[depth], start=1):
        for b in range(n_blocks):
            src, dst = params[f"layer{stage}_{b}"], f"layer{stage}.{b}"
            st = stats[f"layer{stage}_{b}"]
            for ci in range(1, n_convs + 1):
                sd[f"{dst}.conv{ci}.weight"] = _conv(src[f"conv{ci}"]["kernel"])
                _bn(sd, f"{dst}.bn{ci}", src[f"bn{ci}"], st[f"bn{ci}"])
            if "down_conv" in src:
                sd[f"{dst}.downsample.0.weight"] = _conv(src["down_conv"]["kernel"])
                _bn(sd, f"{dst}.downsample.1", src["down_bn"], st["down_bn"])
    return sd


def head_state_dict(params: Mapping, stats: Mapping, proj_type: str = "convmlp") -> Dict:
    sd: Dict = {"step": torch.zeros(1, dtype=torch.long)}
    _proj_head(sd, params, stats, proj_type)
    aspp, aspp_s = params["aspp"], stats["aspp"]
    sd["aspp.branches.0.0.weight"] = _conv(aspp["branch0_conv"]["kernel"])
    _bn(sd, "aspp.branches.0.1", aspp["branch0_bn"], aspp_s["branch0_bn"])
    i = 1
    while f"branch{i}" in aspp:
        _sepconv(sd, f"aspp.branches.{i}.0", aspp[f"branch{i}"], aspp_s[f"branch{i}"])
        i += 1
    sd["aspp.image_pool_conv.0.weight"] = _conv(aspp["image_pool_conv"]["kernel"])
    _bn(sd, "aspp.image_pool_conv.1", aspp["image_pool_bn"], aspp_s["image_pool_bn"])
    sd["bottleneck.0.weight"] = _conv(params["bottleneck_conv"]["kernel"])
    _bn(sd, "bottleneck.1", params["bottleneck_bn"], stats["bottleneck_bn"])
    sd["c1_bottleneck.0.weight"] = _conv(params["c1_conv"]["kernel"])
    _bn(sd, "c1_bottleneck.1", params["c1_bn"], stats["c1_bn"])
    for j in range(2):
        _sepconv(sd, f"sep_bottleneck.{j}", params[f"sep_bottleneck{j}"],
                 stats[f"sep_bottleneck{j}"])
    sd["cls_seg.weight"] = _conv(params["cls_seg"]["kernel"])
    sd["cls_seg.bias"] = _t(params["cls_seg"]["bias"])
    return sd


def aux_head_state_dict(params: Mapping, stats: Mapping) -> Dict:
    sd: Dict = {"0.weight": _conv(params["conv"]["kernel"])}
    _bn(sd, "1", params["bn"], stats["bn"])
    return sd


def _dense(sd: Dict, dst: str, params: Mapping) -> None:
    sd[f"{dst}.weight"] = _t(np.asarray(params["kernel"]).T)
    sd[f"{dst}.bias"] = _t(params["bias"])


def _conv_bias(sd: Dict, dst: str, params: Mapping) -> None:
    sd[f"{dst}.weight"] = _conv(params["kernel"])
    sd[f"{dst}.bias"] = _t(params["bias"])


def _ln(sd: Dict, dst: str, params: Mapping) -> None:
    sd[f"{dst}.weight"] = _t(params["scale"])
    sd[f"{dst}.bias"] = _t(params["bias"])


def mit_backbone_state_dict(params: Mapping, variant: str) -> Dict:
    """A JAX ``MiTBackbone``'s params → the port's ``MiTBackbone`` state dict."""
    sd: Dict = {}
    for s, depth in enumerate(VARIANTS[variant][0], start=1):
        _conv_bias(sd, f"patch_embed{s}.proj", params[f"patch_embed{s}_proj"])
        _ln(sd, f"patch_embed{s}.norm", params[f"patch_embed{s}_norm"])
        for b in range(depth):
            src, dst = params[f"stage{s}_{b}"], f"block{s}.{b}"
            attn, mlp = src["attn"], src["mlp"]
            _ln(sd, f"{dst}.norm1", src["norm1"])
            _dense(sd, f"{dst}.attn.q", attn["q"])
            _dense(sd, f"{dst}.attn.kv", {
                "kernel": np.concatenate([attn["k"]["kernel"], attn["v"]["kernel"]], axis=1),
                "bias": np.concatenate([attn["k"]["bias"], attn["v"]["bias"]])})
            if "sr" in attn:
                _conv_bias(sd, f"{dst}.attn.sr", attn["sr"])
                _ln(sd, f"{dst}.attn.norm", attn["sr_norm"])
            _dense(sd, f"{dst}.attn.proj", attn["proj"])
            _ln(sd, f"{dst}.norm2", src["norm2"])
            _dense(sd, f"{dst}.mlp.fc1", mlp["fc1"])
            _conv_bias(sd, f"{dst}.mlp.dwconv", mlp["dwconv"])
            _dense(sd, f"{dst}.mlp.fc2", mlp["fc2"])
        _ln(sd, f"norm{s}", params[f"norm{s}"])
    return sd


def _proj_head(sd: Dict, params: Mapping, stats: Mapping, proj_type: str) -> None:
    ph = params["proj_head"]
    if proj_type == "convmlp":
        sd["proj_head.proj.0.weight"] = _conv(ph["fc1"]["kernel"])
        _bn(sd, "proj_head.proj.1", ph["bn"], stats["proj_head"]["bn"])
        sd["proj_head.proj.3.weight"] = _conv(ph["fc2"]["kernel"])
    else:
        sd["proj_head.proj.weight"] = _conv(ph["proj"]["kernel"])


def segformer_head_state_dict(params: Mapping, stats: Mapping,
                              proj_type: str = "convmlp") -> Dict:
    """A JAX ``SegFormerMLPHead``'s variables → the port's state dict."""
    sd: Dict = {}
    _proj_head(sd, params, stats, proj_type)
    for i in range(1, 5):
        _dense(sd, f"linear_c{i}", params[f"linear_c{i}"])
    sd["linear_fuse.0.weight"] = _conv(params["linear_fuse"]["conv"]["kernel"])
    _bn(sd, "linear_fuse.1", params["linear_fuse"]["bn"], stats["linear_fuse"]["bn"])
    _conv_bias(sd, "cls_seg", params["cls_seg"])
    return sd


def swin_backbone_state_dict(params: Mapping, variant: str) -> Dict:
    """A JAX ``SwinBackbone``'s params → the port's ``SwinBackbone`` state dict."""
    sd: Dict = {}
    _conv_bias(sd, "patch_embed.proj", params["patch_proj"])
    _ln(sd, "patch_embed.norm", params["patch_norm"])
    for s, depth in enumerate(swin.VARIANTS[variant][1]):
        for b in range(depth):
            src, dst = params[f"stage{s}_{b}"], f"layers.{s}.blocks.{b}"
            attn = src["attn"]
            _ln(sd, f"{dst}.norm1", src["norm1"])
            _dense(sd, f"{dst}.attn.qkv", {
                "kernel": np.concatenate([attn[n]["kernel"] for n in "qkv"], axis=1),
                "bias": np.concatenate([attn[n]["bias"] for n in "qkv"])})
            sd[f"{dst}.attn.relative_position_bias_table"] = _t(attn["rel_bias_table"])
            _dense(sd, f"{dst}.attn.proj", attn["proj"])
            _ln(sd, f"{dst}.norm2", src["norm2"])
            _dense(sd, f"{dst}.mlp.fc1", src["fc1"])
            _dense(sd, f"{dst}.mlp.fc2", src["fc2"])
        if s > 0:
            merge = params[f"merge{s}"]
            _ln(sd, f"layers.{s - 1}.downsample.norm", merge["norm"])
            sd[f"layers.{s - 1}.downsample.reduction.weight"] = _t(
                np.asarray(merge["reduction"]["kernel"]).T)
        _ln(sd, f"norm{s}", params[f"out_norm{s}"])
    return sd


def _deconv(sd: Dict, dst: str, params: Mapping) -> None:
    sd[f"{dst}.weight"] = _t(np.asarray(params["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1))
    sd[f"{dst}.bias"] = _t(params["bias"])


def vit_backbone_state_dict(params: Mapping, variant: str) -> Dict:
    """A JAX ``ViTBackbone``'s params → the port's ``ViTBackbone`` state dict."""
    sd: Dict = {"cls_token": _t(params["cls_token"])}
    if "reg_tokens" in params:
        sd["reg_token"] = _t(params["reg_tokens"])
    sd["pos_embed"] = _t(params["pos_embed"])
    _conv_bias(sd, "patch_embed.proj", params["patch_embed"])
    for i in range(vit.VARIANTS[variant][1]):
        src, dst = params[f"block{i}"], f"blocks.{i}"
        _ln(sd, f"{dst}.norm1", src["norm1"])
        _dense(sd, f"{dst}.attn.qkv", src["attn"]["qkv"])
        _dense(sd, f"{dst}.attn.proj", src["attn"]["proj"])
        _ln(sd, f"{dst}.norm2", src["norm2"])
        _dense(sd, f"{dst}.mlp.fc1", src["mlp_fc1"])
        _dense(sd, f"{dst}.mlp.fc2", src["mlp_fc2"])
        for j in (1, 2):
            if f"ls{j}_gamma" in src:
                sd[f"{dst}.ls{j}.gamma"] = _t(src[f"ls{j}_gamma"])
    _ln(sd, "norm", params["norm"])
    _deconv(sd, "fpn1.0", params["fpn1_deconv1"])
    _ln(sd, "fpn1.1", params["fpn1_norm"])
    _deconv(sd, "fpn1.3", params["fpn1_deconv2"])
    _deconv(sd, "fpn2.0", params["fpn2_deconv"])
    return sd


def _cbr(sd: Dict, dst: str, params: Mapping, stats: Mapping) -> None:
    """A JAX ``ConvBNReLU`` → the port's ``_conv_bn_relu`` (``.0`` conv, ``.1`` BN)."""
    sd[f"{dst}.0.weight"] = _conv(params["conv"]["kernel"])
    _bn(sd, f"{dst}.1", params["bn"], stats["bn"])


def upernet_head_state_dict(params: Mapping, stats: Mapping,
                            proj_type: str = "convmlp") -> Dict:
    """A JAX ``UPerNetHead``'s variables → the port's state dict."""
    sd: Dict = {}
    _proj_head(sd, params, stats, proj_type)
    i = 0
    while f"psp{i}" in params:
        _cbr(sd, f"psp_modules.{i}", params[f"psp{i}"], stats[f"psp{i}"])
        i += 1
    _cbr(sd, "bottleneck", params["psp_bottleneck"], stats["psp_bottleneck"])
    for i in range(3):
        _cbr(sd, f"lateral_convs.{i}", params[f"lateral{i}"], stats[f"lateral{i}"])
        _cbr(sd, f"fpn_convs.{i}", params[f"fpn{i}"], stats[f"fpn{i}"])
    _cbr(sd, "fpn_bottleneck", params["fuse"], stats["fuse"])
    _conv_bias(sd, "cls_seg", params["cls_seg"])
    return sd


def export_reference_checkpoint(variables: Mapping, depth: int,
                                proj_type: str = "convmlp",
                                mit_variant: Optional[str] = None,
                                swin_variant: Optional[str] = None,
                                vit_variant: Optional[str] = None) -> Dict:
    """JAX variables (numpy leaves) → reference-layout checkpoint dict: a
    ResNet of ``depth`` with the sep-ASPP head, with ``mit_variant`` a MiT
    backbone with the SegFormer head, or with ``swin_variant`` /
    ``vit_variant`` a Swin / ViT backbone with UperNet."""
    params, stats = variables["params"], variables["batch_stats"]
    if vit_variant is not None:
        parts = (vit_backbone_state_dict(params["backbone"], vit_variant),
                 upernet_head_state_dict(params["head"], stats["head"], proj_type))
    elif swin_variant is not None:
        parts = (swin_backbone_state_dict(params["backbone"], swin_variant),
                 upernet_head_state_dict(params["head"], stats["head"], proj_type))
    elif mit_variant is not None:
        parts = (mit_backbone_state_dict(params["backbone"], mit_variant),
                 segformer_head_state_dict(params["head"], stats["head"], proj_type))
    else:
        parts = (backbone_state_dict(params["backbone"], stats["backbone"], depth),
                 head_state_dict(params["head"], stats["head"], proj_type))
    out = {"epoch": 0, "backbone_state_dict": parts[0], "aspp_head_state_dict": parts[1]}
    if "aux_head" in params:
        out["aux_head_state_dict"] = aux_head_state_dict(params["aux_head"], stats["aux_head"])
    return out


def load_reference_checkpoint(model: nn.Module, ckpt: Mapping) -> nn.Module:
    """Load a reference-layout checkpoint dict into a ``HieroSegmenter``.
    The backbone and decode head must be present; the aux head loads when
    the checkpoint has one (serving never runs it)."""
    missing = [k for k in ("backbone_state_dict", "aspp_head_state_dict") if k not in ckpt]
    if missing:
        raise KeyError(f"not a reference checkpoint: missing {missing}; have {sorted(ckpt)}")
    for key, attr in PARTS.items():
        if key in ckpt:
            getattr(model, attr).load_state_dict(ckpt[key], strict=True)
    return model


def reference_checkpoint(model: nn.Module) -> Dict:
    """The port's model → a reference-layout checkpoint dict (the inverse
    of :func:`load_reference_checkpoint`)."""
    out: Dict = {"epoch": 0}
    for key, attr in PARTS.items():
        out[key] = {k: v.detach().cpu() for k, v in getattr(model, attr).state_dict().items()}
    return out


def load_torch_file(path: str) -> Dict:
    """The dict a ``.pth`` file holds, on the CPU: read with
    ``weights_only=True`` (tensors and containers alone), and only where
    the file needs other objects with a full unpickle."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        return torch.load(path, map_location="cpu", weights_only=False)


def import_torchvision_backbone(sd: Mapping, depth: int) -> Dict:
    """A torchvision ResNet state dict → the state dict of the port's
    ``ResNetBackbone`` of ``depth``. Takes torchvision's stem names
    (``conv1``, ``bn1``) or the reference wrapper's (``stem_conv``,
    ``stem_bn``); drops the classifier (``fc.*``). Raises when the blocks
    the dict holds are not those of ``depth``. (A dict without
    ``num_batches_tracked``, as older files have, still loads strictly:
    BatchNorm fills it in.)"""
    out: Dict = {}
    for k, v in sd.items():
        if k.startswith("fc."):
            continue
        k = re.sub(r"^conv1\.", "stem_conv.", k)
        k = re.sub(r"^bn1\.", "stem_bn.", k)
        out[k] = v
    blocks = [0, 0, 0, 0]
    bottleneck = False
    for k in out:
        m = re.match(r"layer([1-4])\.(\d+)\.conv(\d)\.weight$", k)
        if m:
            stage, b = int(m.group(1)) - 1, int(m.group(2))
            blocks[stage] = max(blocks[stage], b + 1)
            bottleneck |= m.group(3) == "3"
    want = (tuple(STAGE_BLOCKS[depth]), depth in BOTTLENECK_DEPTHS)
    if (tuple(blocks), bottleneck) != want:
        found = [d for d, n in STAGE_BLOCKS.items()
                 if (tuple(n), d in BOTTLENECK_DEPTHS) == (tuple(blocks), bottleneck)]
        raise ValueError(
            f"the pretrained weights are a ResNet-{found[0] if found else '?'} "
            f"(blocks per stage {blocks}), not the ResNet-{depth} of model.depth")
    return out


def load_pretrained_backbone(model: nn.Module, path: str, depth: int) -> nn.Module:
    """Load a local torchvision-layout ResNet ``.pth`` (its state dict, or
    a dict holding it under ``state_dict``) into ``model.backbone`` with
    ``strict=True``: parameters and BatchNorm running statistics."""
    sd = load_torch_file(path)
    sd = sd.get("state_dict", sd)
    model.backbone.load_state_dict(import_torchvision_backbone(sd, depth), strict=True)
    return model
