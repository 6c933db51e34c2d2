"""What the kernel counts read of one step or batch, taken from the
configuration's plain reference model: one forward pass of it on the meta
device at the unit's batch and input size gives the logits' size and the
shape of every 3x3 depthwise convolution it runs.

The pass takes some tenths of a second on the host. A driver whose run
traces a segment (``ctx.trace``) makes its unit once at set-up and hands
it out for every step or batch, so that the pass never falls inside the
traced segment."""

from __future__ import annotations

from types import ModuleType
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class _Depthwise(TorchDispatchMode):
    """Records ``(B, H, W, C, dilation)`` of every convolution with a 3x3
    kernel and ``groups == in == out`` channels, at its output's size, in
    the order they run. It sees the convolution operator itself, so it
    finds ``nn.Conv2d`` modules and ``F.conv2d`` calls alike."""

    def __init__(self):
        super().__init__()
        self.shapes: List[Tuple[int, ...]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.convolution.default:
            x, w = args[0], args[1]
            dilation, transposed, groups = args[5], args[6], args[8]
            if (not transposed and w.dim() == 4 and tuple(w.shape[-2:]) == (3, 3)
                    and groups == x.shape[1] == w.shape[0] and w.shape[1] == 1):
                if dilation[0] != dilation[1]:
                    raise ValueError(f"a depthwise 3x3 of dilation {dilation} is not counted")
                B, C, H, W = out.shape
                self.shapes.append((B, H, W, C, int(dilation[0])))
        return out


def reference_pass(reference: ModuleType, model_cfg: Dict, tree, batch: int, hw,
                   train: bool) -> Tuple[Tuple[int, int], List[Tuple[int, ...]]]:
    """(the logits' ``(h, w)``, every depthwise 3x3's ``(B, H, W, C,
    dilation)``) of ``reference``'s model at ``batch`` x ``hw``, with the
    training heads where ``train``."""
    model = reference.build(model_cfg, tree).eval()  # shapes alike; eval takes batch 1
    mode = _Depthwise()
    with torch.no_grad(), mode:
        out = model(torch.zeros(int(batch), 3, *hw, device="meta"), with_train_heads=train)
    return tuple(out["logits"].shape[-2:]), mode.shapes


def unit(batch: int, hw, tree, reference: ModuleType, model_cfg: Dict, train: bool = False,
         valid: int = 0, logits_bytes: int = 4) -> Dict:
    """What the kernel counts read of one step or batch: the batch, the
    input size, the logits' size (``hw4``), the levels' class counts, the
    depthwise 3x3 convolutions' shapes (``depthwise``: ``(B, H, W, C,
    dilation)`` each), the valid label pixels (training) and the logits'
    bytes per value (the decode kernel's input)."""
    hw4, depthwise = reference_pass(reference, model_cfg, tree, batch, hw, train)
    levels = [tree.n_fine, tree.n_coarse] + ([tree.n_super] if tree.n_super else [])
    return {"batch": int(batch), "hw": tuple(hw), "hw4": hw4, "levels": levels,
            "depthwise": depthwise, "valid": int(valid), "logits_bytes": int(logits_bytes)}
