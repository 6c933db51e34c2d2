"""The numbers that decide ``correct``, from the program's readings and the
reference's.

Training, per leaf: the gap between the program's norm and the
reference's, over the reference's norm of that leaf or of the median
leaf, whichever is larger. The change comparison leaves out leaves whose
first reference gradient is under a thousandth of the median leaf's (they
move by weight decay and round-off alone).

Prediction: at every pixel of a returned mask, how far the reference's
logit of the returned class lies below the reference's best logit of
that level; the widest such gap, over the standard deviation of the
reference's logits of that level in that image (random weights give
logits whose spread moves several-fold from seed to seed).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

import torch

NOUGHT = 1e-3  # a leaf's first gradient under this share of the median leaf's


def _median(xs: Iterable[float]) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else 0.0


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keys: Optional[List[str]] = None) -> Dict[str, float]:
    """Per leaf ``|‖prog‖ − ‖ref‖| / max(‖ref‖, median ‖ref‖)``."""
    keys = list(ref) if keys is None else keys
    med = _median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def train_numbers(prog: Dict, ref: Dict) -> Dict:
    """``prog`` and ``ref``: ``losses`` (one per step), ``logits`` (the
    first step's), ``grad_norms`` and ``change_norms`` (by leaf). The
    numbers: ``loss_gap``, the largest relative gap of a step's loss
    (``loss_gap_first``: the first step's, ``loss_gap_median``: the
    median step's, ``loss_gaps``: each step's);
    ``logits_gap``, the first step's logits' RMS gap over the reference
    logits' standard deviation; ``grad_gap`` and ``change_gap``, the
    median leaf's gap of the first gradient and of the change. The worst
    leaf's gaps, and the leaves they were read at, go beside them (bf16
    moves single small leaves by up to a tenth where a bf16 reference
    does the same; ``PERF.md``). A cell's limits file names the numbers
    it compares."""
    if len(prog["losses"]) != len(ref["losses"]) or not all(
            math.isfinite(x) for x in prog["losses"]):
        steps = [float("inf")] * max(1, len(ref["losses"]))
    else:
        steps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    gref = ref["grad_norms"]
    med = _median(gref.values())
    moving = [k for k, v in gref.items() if v >= NOUGHT * med]
    g = leaf_gaps(prog["grad_norms"], gref)
    c = leaf_gaps(prog["change_norms"], ref["change_norms"], moving)
    gw, cw = max(g, key=g.get), max(c, key=c.get)
    logits_gap = float("inf")
    if prog.get("logits") is not None and prog["logits"].shape == ref["logits"].shape:
        d = (prog["logits"].float() - ref["logits"]).square().mean().sqrt()
        logits_gap = float(d / ref["logits"].std())
    return {"loss_gap": max(steps), "loss_gap_first": steps[0],
            "loss_gap_median": sorted(steps)[len(steps) // 2], "loss_gaps": steps,
            "logits_gap": logits_gap, "grad_gap": _median(g.values()),
            "change_gap": _median(c.values()), "grad_worst": g[gw], "grad_worst_leaf": gw,
            "change_worst": c[cw], "change_worst_leaf": cw,
            "leaves_left_out": len(gref) - len(moving)}


def widest_gap(ref_logits: torch.Tensor, mask: torch.Tensor) -> float:
    """``ref_logits`` ``[C, H, W]`` of one level, ``mask`` ``[H, W]`` of
    class ids: the largest ``max_c ref − ref[mask]`` over the logits'
    standard deviation; a class id out of range reads infinite."""
    mask = mask.to(ref_logits.device).long()
    if mask.shape != ref_logits.shape[1:] or int(mask.min()) < 0 \
            or int(mask.max()) >= ref_logits.shape[0]:
        return float("inf")
    picked = ref_logits.gather(0, mask[None])[0]
    return float((ref_logits.amax(0) - picked).amax() / ref_logits.std())
