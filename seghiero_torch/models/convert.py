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

``load_reference_checkpoint`` loads such a dict into the port's model,
each part with ``strict=True``.

``import_torchvision_backbone`` takes a torchvision ResNet state dict
(``model.pretrained: <path>``, read by ``load_torch_file``) to the
backbone's own names, and ``load_pretrained_backbone`` loads it.
"""

from __future__ import annotations

import pickle
import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

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
    ph = params["proj_head"]
    if proj_type == "convmlp":
        sd["proj_head.proj.0.weight"] = _conv(ph["fc1"]["kernel"])
        _bn(sd, "proj_head.proj.1", ph["bn"], stats["proj_head"]["bn"])
        sd["proj_head.proj.3.weight"] = _conv(ph["fc2"]["kernel"])
    else:
        sd["proj_head.proj.weight"] = _conv(ph["proj"]["kernel"])
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


def export_reference_checkpoint(variables: Mapping, depth: int,
                                proj_type: str = "convmlp") -> Dict:
    """JAX variables (numpy leaves) → reference-layout checkpoint dict."""
    params, stats = variables["params"], variables["batch_stats"]
    out = {
        "epoch": 0,
        "backbone_state_dict": backbone_state_dict(params["backbone"], stats["backbone"], depth),
        "aspp_head_state_dict": head_state_dict(params["head"], stats["head"], proj_type),
    }
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
