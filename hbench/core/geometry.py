"""Shapes of the segmenter's layers at an input size: the stride-4 map
after the 7×7 stride-2 stem and the 3×3 stride-2 max pool (padding 3 and
1), where the decode head's depthwise convolutions and its logits live."""

from __future__ import annotations

from typing import Dict, Tuple


def stride4(hw) -> Tuple[int, int]:
    def one(n):
        n = (n + 2 * 3 - 7) // 2 + 1
        return (n + 2 * 1 - 3) // 2 + 1

    return one(hw[0]), one(hw[1])


def unit(batch: int, hw, tree, model_cfg: Dict, valid: int = 0,
         logits_bytes: int = 4) -> Dict:
    """What the kernel counts read of one step or batch: the batch, the
    input size, the stride-4 size, the levels' class counts, the decode
    head's widths, the valid label pixels (training) and the logits' bytes
    per value (the decode kernel's input)."""
    levels = [tree.n_fine, tree.n_coarse] + ([tree.n_super] if tree.n_super else [])
    return {"batch": int(batch), "hw": tuple(hw), "hw4": stride4(hw), "levels": levels,
            "aspp_channels": int(model_cfg.get("aspp_channels", 512)),
            "c1_channels": int(model_cfg.get("c1_channels", 48)),
            "valid": int(valid), "logits_bytes": int(logits_bytes)}
