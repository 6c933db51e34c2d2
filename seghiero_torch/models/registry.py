"""Backbone / decode-head registries (counterpart of
``seghiero_tpu/models/registry.py``).

A builder registered under a name is selected from YAML
(``model.backbone`` / ``model.head``). Backbone builders take the config
and return a module mapping NCHW images to four feature maps; head
builders take the config and the backbone's four stage widths. Names the
JAX package knows but the port has not ported yet raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Dict

_BACKBONES: Dict[str, Callable] = {}
_HEADS: Dict[str, Callable] = {}

# families of the JAX package still to be ported (ROADMAP.md queue 1, item 8)
NOT_PORTED_BACKBONES = ("convnext", "hrnet", "unet", "mit", "vit", "swin")
NOT_PORTED_HEADS = ("aspp", "segformer_mlp", "upernet")


def register_backbone(name: str) -> Callable:
    def deco(fn: Callable) -> Callable:
        _BACKBONES[name] = fn
        return fn

    return deco


def register_head(name: str) -> Callable:
    def deco(fn: Callable) -> Callable:
        _HEADS[name] = fn
        return fn

    return deco


def _lookup(table: Dict[str, Callable], not_ported, kind: str, name: str) -> Callable:
    if name in table:
        return table[name]
    if name in not_ported:
        raise NotImplementedError(
            f"model.{kind} {name!r} is not ported to seghiero_torch yet "
            "(ROADMAP.md queue 1, item 8); the port has "
            f"{sorted(table)}"
        )
    raise ValueError(f"unknown model.{kind} {name!r}; registered: {sorted(table)}")


def backbone_builder(name: str) -> Callable:
    return _lookup(_BACKBONES, NOT_PORTED_BACKBONES, "backbone", name)


def head_builder(name: str) -> Callable:
    return _lookup(_HEADS, NOT_PORTED_HEADS, "head", name)
