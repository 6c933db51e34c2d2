"""The plain float32 reference of the training losses, from the model's
outputs and the fine labels (255 = ignore):

* two levels: ``5·(BCE_fine + BCE_coarse) + CE_fine + CE_coarse +
  ready·ramp(step)·triplet_range`` (HieraSeg's hierarchy BCE, whose
  positive is the min over the label's ancestors and whose negative the
  max over each class's descendants);
* three levels: ``λ·RMI + 0.5·5·(BCE_fine + BCE_mid + BCE_high) + three
  CEs + ready·ramp(step)·triplet_groups`` with RMI's lower bound over the
  3×3 neighbourhoods of every level's one-hot and sigmoid maps;
* the aux head's CE over valid pixels, weighted 0.4.

Logits are upsampled bilinearly (half-pixel) to the label size in f32.
Every quantity is materialized; nothing here is fused or streamed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from hbench.reference import lowp
from hbench.reference.tree import IGNORE, Tree

AUX_WEIGHT = 0.4
RMI_CLIP = 1e-6
RMI_ALPHA = 1e-3
RMI_EPS_REL = 32 * float(np.finfo(np.float32).eps)
TRIPLET_K, TRIPLET_MARGIN = 200, 0.6


def up(lo: torch.Tensor, hw) -> torch.Tensor:
    return F.interpolate(lo.float(), size=tuple(hw), mode="bilinear", align_corners=False)


def _lut(table: Sequence[int], t: torch.Tensor) -> torch.Tensor:
    lut = torch.as_tensor(list(table) + [0] * (256 - len(table)), device=t.device)
    valid = (t >= 0) & (t < len(table))
    return torch.where(valid, lut[t.clamp(0, 255).long()], IGNORE)


def _pick(x, t):
    return x.gather(1, t.unsqueeze(1).long()).squeeze(1)


def _log_p(x, eps):  # log(sigmoid(x) + eps)
    return torch.logaddexp(F.logsigmoid(x), torch.full_like(x, math.log(eps)))


def _log_1mp(x, eps):  # log(1 - sigmoid(x) + eps)
    return _log_p(-x, eps)


def _level_bce(pos_lbl, neg, t, n, eps):
    valid = t != IGNORE
    safe = torch.where(valid, t, 0)
    per = _log_p(pos_lbl, eps) + _log_1mp(neg, eps).sum(1) - _log_1mp(_pick(neg, safe), eps)
    return torch.where(valid, -per, 0.0).sum() / (valid.sum().clamp(min=1) * n)


def _bucket_max(child, buckets: List[List[int]], own):
    return torch.stack([torch.maximum(child[:, ids].amax(1), own[:, i])
                        for i, ids in enumerate(buckets)], 1)


def ce(logits, t, over_valid: bool = False):
    valid = t != IGNORE
    safe = torch.where(valid, t, 0)
    nll = torch.where(valid, torch.logsumexp(logits, 1) - _pick(logits, safe), 0.0).sum()
    return nll / (valid.sum().clamp(min=1) if over_valid else t.numel())


def hiera_bce(lf, labels, tree: Tree, eps):
    nf, nc = tree.n_fine, tree.n_coarse
    la, lb = lf[:, :nf], lf[:, nf:nf + nc]
    t_c = _lut(tree.fine_to_coarse, labels)
    sf, sc = torch.where(labels != IGNORE, labels, 0), torch.where(t_c != IGNORE, t_c, 0)
    mcmb = _bucket_max(la, tree.children(tree.fine_to_coarse), lb)
    lb_lbl = _pick(lb, sc)
    loss = _level_bce(torch.minimum(_pick(la, sf), lb_lbl), la, labels, nf, eps)
    if not tree.n_super:
        return 5.0 * (loss + _level_bce(lb_lbl, mcmb, t_c, nc, eps))
    lc = lf[:, nf + nc:]
    t_s = _lut(tree.fine_to_super, labels)
    ss = torch.where(t_s != IGNORE, t_s, 0)
    mcmc = _bucket_max(mcmb, tree.children(tree.coarse_to_super), lc)
    pos_m = torch.minimum(lb_lbl, _pick(lc, _lut(tree.coarse_to_super, sc)))
    loss = loss + _level_bce(pos_m, mcmb, t_c, nc, eps)
    return 5.0 * (loss + _level_bce(_pick(lc, ss), mcmc, t_s, tree.n_super, eps))


def _jitter(m, n):
    mean_diag = torch.diagonal(m, dim1=-2, dim2=-1).mean(-1)
    return torch.clamp(RMI_EPS_REL * mean_diag, min=RMI_ALPHA / n)[..., None, None]


def rmi(oh: torch.Tensor, pr: torch.Tensor) -> torch.Tensor:
    """RMI's lower bound summed over maps (mean over the batch, / 9) from
    the one-hot and probability maps ``[B, C, H, W]``: the 3×3 views of
    the ``(H−2)·(W−2)`` output pixels scaled by 1/√N, W regressed from the
    jittered probability covariance, and 0.5·logdet of the jittered
    residual Gram."""
    B, C, H, W = pr.shape
    nh, nw = H - 2, W - 2
    n = nh * nw

    def views(m):
        return torch.stack([m[:, :, dy:dy + nh, dx:dx + nw] for dy in range(3)
                            for dx in range(3)], 2).reshape(B, C, 9, n) / math.sqrt(n)

    la, p = views(oh.detach()), views(pr)
    eye = torch.eye(9, device=pr.device)
    pr_cov = p @ p.mT
    w = torch.linalg.solve(pr_cov + eye * _jitter(pr_cov, n), (la @ p.mT).mT)
    r = la - w.mT @ p
    a = r @ r.mT
    a = 0.5 * (a + a.mT)
    chol = torch.linalg.cholesky(a + eye * _jitter(a, n))
    half = torch.log(torch.diagonal(chol, dim1=-2, dim2=-1) * math.sqrt(n) + 1e-8).sum(-1)
    return (half.mean(0) / 9.0).sum()


def _nearest(labels, hw):
    H, W = labels.shape[-2:]
    ys = torch.arange(hw[0], device=labels.device) * H // hw[0]
    xs = torch.arange(hw[1], device=labels.device) * W // hw[1]
    return labels[:, ys[:, None], xs[None, :]]


def triplet(emb, labels, rows):
    """Tree-triplet loss and the number of anchor classes that had
    triplets. ``rows``: per anchor class ``(anchor, positive, negative)``
    boolean masks over the embedding's pixels; each class pairs its first
    ``min(#a, #p, #n, 200)`` anchors, positives and negatives in pixel
    order under cosine distance and margin 0.6."""
    feats = emb.permute(0, 2, 3, 1).reshape(-1, emb.shape[1])
    losses = []
    for a, p, n in rows:
        k = min(int(a.sum()), int(p.sum()), int(n.sum()), TRIPLET_K)
        if k == 0:
            continue
        fa, fp, fn = (feats[m.nonzero()[:k, 0]] for m in (a, p, n))
        tl = F.relu((1 - (fa * fp).sum(-1)) - (1 - (fa * fn).sum(-1)) + TRIPLET_MARGIN)
        losses.append(tl.sum() / k)
    if not losses:
        return emb.sum() * 0.0, 0
    return torch.stack(losses).mean(), len(losses)


def triplet_rows(tree: Tree, lbl: torch.Tensor):
    """Anchor / positive / negative masks per fine class: two levels, the
    range variant (positives in the class's coarse bucket, negatives
    outside it, ignored pixels included); three levels, the group variant
    (non-background classes grouped by the super bucket of class 1;
    positives the rest of the class's group, negatives the other group)."""
    rows = []
    if not tree.n_super:
        buckets = tree.children(tree.fine_to_coarse)
        for c in range(tree.n_fine):
            bucket = torch.isin(lbl, torch.as_tensor(buckets[tree.fine_to_coarse[c]],
                                                     device=lbl.device))
            rows.append((lbl == c, bucket & (lbl != c), ~bucket))
        return rows
    f2s = tree.fine_to_super
    ids = list(range(1, tree.n_fine))
    upper = [f for f in ids if f2s[f] == f2s[ids[0]]]
    lower = [f for f in ids if f2s[f] != f2s[ids[0]]]
    for group, other in ((upper, lower), (lower, upper)):
        for c in group:
            own = torch.isin(lbl, torch.as_tensor([g for g in group if g != c] or [-1],
                                                  device=lbl.device))
            rows.append((lbl == c, own, torch.isin(lbl, torch.as_tensor(other or [-1],
                                                                        device=lbl.device))))
    return rows


def ramp(step: int, total: int) -> float:
    if step >= total:
        return 0.5
    return 0.25 * (1.0 + math.cos((step - total) / total * math.pi))


def stored(x: torch.Tensor, low: bool) -> torch.Tensor:
    """``x`` as a lower-precision store keeps it where the configuration
    stores bf16 (``low``): the control's fp8, the witness's bf16, else as
    it is."""
    if low and lowp.enabled():
        return lowp.q8(x)
    if low and lowp.mode() == "bf16":
        return x.to(torch.bfloat16).float()
    return x


def total_loss(out: Dict[str, torch.Tensor], labels: torch.Tensor, tree: Tree, step: int,
               rmi_weight: float = 1.0, low_logits: bool = False,
               low_rmi: bool = False) -> torch.Tensor:
    """The training loss of one batch at optimizer step ``step``, in f32.
    ``low_logits`` / ``low_rmi``: the configuration stores the upsampled
    logits / RMI's maps in bf16 (``hiera_precision`` / ``rmi_precision:
    fast``), so the control stores them in fp8."""
    labels = labels.long()
    hw = labels.shape[-2:]
    lf = stored(up(stored(out["logits"], low_logits), hw), low_logits)
    lv = tree.levels
    emb = out["embedding"]
    lbl = _nearest(labels, emb.shape[-2:]).reshape(-1)
    t, count = triplet(emb, lbl, triplet_rows(tree, lbl))
    if not tree.n_super:
        main = hiera_bce(lf, labels, tree, 1e-8)
        targets = {"fine": labels, "coarse": _lut(tree.fine_to_coarse, labels)}
        total_steps = 80_000
    else:
        main = 0.5 * hiera_bce(lf, labels, tree, RMI_CLIP)
        targets = {"fine": labels, "coarse": _lut(tree.fine_to_coarse, labels),
                   "super": _lut(tree.fine_to_super, labels)}
        ohs, valids = [], []
        for lvl, tgt in targets.items():
            a, b = lv[lvl]
            valid = tgt != IGNORE
            ohs.append(F.one_hot(torch.where(valid, tgt, 0), b - a).permute(0, 3, 1, 2).float())
            valids.append(valid[:, None].float().expand(-1, b - a, -1, -1))
        valid_all = torch.cat(valids, 1)
        main = main + rmi_weight * rmi(torch.cat(ohs, 1), stored(
            torch.sigmoid(lf) * valid_all + RMI_CLIP, low_rmi))
        total_steps = 160_000 if tree.n_fine > 15 else 60_000
    for lvl, tgt in targets.items():
        a, b = lv[lvl]
        main = main + ce(lf[:, a:b], tgt)
    if count:
        main = main + ramp(step, total_steps) * t
    aux_lo = stored(out["aux_logits"], low_logits)
    aux = ce(stored(up(aux_lo, hw), low_logits), labels, over_valid=True)
    return main + AUX_WEIGHT * aux
