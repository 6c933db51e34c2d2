"""The composite losses in C-major layout (the port of
``seghiero_tpu/losses/fast.py``: ``_pick_channel``,
``_masked_level_bce_pick``, ``_ce_cmajor``, ``_bucket_max_cmajor``,
``hiera_bce_two_level_cmajor``, ``hiera_bce_three_level_cmajor``,
``FastHieraTripletLoss`` and ``FastRMIHieraTripletLoss`` with
``hiera_variant: bce``, ``aux_ce_fast``; the RMI term is in
``losses/rmi.py``).

The port takes its model's outputs as they come: logits ``[B, C, h, w]``
and embedding ``[B, D, h', w']`` (NCHW, any memory format). The logits
are made C-major contiguous once at low resolution — the JAX package's
transpose. All loss math runs in f32. ``training.hiera_precision: fast``
stores the logits and their upsample in bf16 where JAX does
(``ops/resize.py`` ``resize_bilinear_bf16``: the same bits), and every
consumer upcasts to f32; ``parity`` upsamples in f32.

With ``use_kernel`` (``training.pallas_fused_loss: true``) the upsample,
hierarchy BCE and both CE terms go through the fused kernels
(``ops/hiera2_fused.py``), which take labels 4× the logits' size (on the
card another ratio raises; on the CPU it takes the unfused path, as JAX
does); otherwise through ``F.interpolate`` and the
PyTorch ops below (autograd splits ``min``/``max`` ties in half, as JAX
does on its unfused path).
"""

from __future__ import annotations

from typing import Sequence

import torch

from seghiero_torch.hierarchy import Hierarchy
from seghiero_torch.losses.hiera import (
    _log_one_minus_sig_eps,
    _log_sig_eps,
    _one_hot_valid,
    device_table,
    lut_lookup,
    prepare_targets_three_level,
    prepare_targets_two_level,
)
from seghiero_torch.losses.rmi import _CLIP_MIN, rmi_lower_bound_cmajor
from seghiero_torch.losses.tree_triplet import (
    tree_triplet_loss_groups,
    tree_triplet_loss_range,
    triplet_readiness,
    triplet_schedule_factor,
)
from seghiero_torch.ops.hiera2_fused import SCALE, fused_hiera2_loss_sums
from seghiero_torch.ops.resize import resize_bilinear, resize_bilinear_bf16


def _pick_channel(x: torch.Tensor, t_safe: torch.Tensor) -> torch.Tensor:
    """``x[b, t[b,h,w], h, w]``; ``t_safe`` in ``[0, x.shape[1])``."""
    return x.gather(1, t_safe.unsqueeze(1).long()).squeeze(1)


def _masked_level_bce_pick(pos_at_lbl, neg_l, targets, n: int, ignore_index: int,
                           eps: float = 1e-8) -> torch.Tensor:
    """Σ_valid(−log σ(pos)[lbl] − Σ_{c≠lbl} log(1−σ(neg_c))) / (n_valid · n),
    with the positive already picked at the label channel."""
    valid = targets != ignore_index
    safe = torch.where(valid, targets, 0)
    nv = torch.clamp(valid.sum().to(torch.float32), min=1.0)
    neg_l = neg_l.to(torch.float32)
    neg_sum = _log_one_minus_sig_eps(neg_l, eps).sum(1)
    neg_lbl = _log_one_minus_sig_eps(_pick_channel(neg_l, safe), eps)
    pos_lbl = _log_sig_eps(pos_at_lbl.to(torch.float32), eps)
    per_px = pos_lbl + neg_sum - neg_lbl
    return torch.where(valid, -per_px, 0.0).sum() / (nv * n)


def _ce_cmajor(logits, targets, ignore_index: int, divide_by: str = "all") -> torch.Tensor:
    """Softmax CE on ``[B, C, H, W]`` logits as ``logsumexp − logit[label]``.
    ``divide_by="all"`` divides by the number of label pixels,
    ``"valid"`` by ``max(n_valid, 1)`` (finite on an all-ignored batch)."""
    logits = logits.to(torch.float32)
    valid = targets != ignore_index
    safe = torch.where(valid, targets, 0)
    pick = _pick_channel(logits, safe) - torch.logsumexp(logits, 1)
    total = torch.where(valid, -pick, 0.0).sum()
    if divide_by == "all":
        return total / targets.numel()
    return total / torch.clamp(valid.sum().to(torch.float32), min=1.0)


def _bucket_max_cmajor(child_l, buckets: Sequence[Sequence[int]], own_l) -> torch.Tensor:
    """Per coarse bucket: max over its fine children and its own channel
    (``amax`` and ``maximum`` split ties evenly in the backward, as JAX)."""
    sizes = [len(ids) for ids in buckets]
    flat = [c for ids in buckets for c in ids]
    if sizes and min(sizes) == max(sizes) > 0 and flat == list(range(len(flat))) \
            and child_l.shape[1] == len(flat):
        B, C, H, W = child_l.shape
        g = torch.amax(child_l.reshape(B, len(buckets), sizes[0], H, W), dim=2)
        return torch.maximum(g, own_l)
    cols = []
    for i, ids in enumerate(buckets):
        o = own_l[:, i]
        if ids:
            idx = device_table(tuple(int(c) for c in ids), torch.int64, child_l.device)
            o = torch.maximum(torch.amax(child_l[:, idx], dim=1), o)
        cols.append(o)
    return torch.stack(cols, dim=1)


def hiera_bce_two_level_cmajor(lf, t_fine, t_coarse, h: Hierarchy, eps: float = 1e-8):
    """2-level hierarchy BCE, ``5·(fine + coarse)``, on ``[B, C, H, W]``
    logits; the min-composed positive is evaluated at the label channel
    only."""
    nf, nc = h.n_fine, h.n_coarse
    la, lb = lf[:, :nf], lf[:, nf : nf + nc]
    mcmb = _bucket_max_cmajor(la, h.fine_by_coarse, lb)
    sf = torch.where(t_fine != h.ignore_index, t_fine, 0)
    sc = torch.where(t_coarse != h.ignore_index, t_coarse, 0)
    lb_lbl = _pick_channel(lb, sc)
    pos_f = torch.minimum(_pick_channel(la, sf), lb_lbl)
    loss_f = _masked_level_bce_pick(pos_f, la, t_fine, nf, h.ignore_index, eps)
    loss_c = _masked_level_bce_pick(lb_lbl, mcmb, t_coarse, nc, h.ignore_index, eps)
    return 5.0 * (loss_f + loss_c)


def hiera_bce_three_level_cmajor(lf, t_f, t_m, t_h, h: Hierarchy, clip_min: float = _CLIP_MIN):
    """3-level hierarchy BCE, ``5·(fine + mid + high)``, with ``clip_min`` as
    the log guard. The positive min-chains are evaluated at the label
    channel only; the mid pick composes ``coarse_to_super`` from the *mid*
    label, not ``fine_to_super`` from the fine one."""
    nf, nm, nh = h.n_fine, h.n_coarse, h.n_super
    la, lb, lc = lf[:, :nf], lf[:, nf : nf + nm], lf[:, nf + nm : nf + nm + nh]
    mcmb = _bucket_max_cmajor(la, h.fine_by_coarse, lb)
    mcmc = _bucket_max_cmajor(mcmb, h.coarse_by_super, lc)
    sf = torch.where(t_f != h.ignore_index, t_f, 0)
    sm = torch.where(t_m != h.ignore_index, t_m, 0)
    sh = torch.where(t_h != h.ignore_index, t_h, 0)
    lb_lbl = _pick_channel(lb, sm)
    pos_f = torch.minimum(_pick_channel(la, sf), lb_lbl)
    pos_m = torch.minimum(lb_lbl, _pick_channel(lc, lut_lookup(h.coarse_to_super, sm)))
    loss_f = _masked_level_bce_pick(pos_f, la, t_f, nf, h.ignore_index, clip_min)
    loss_m = _masked_level_bce_pick(pos_m, mcmb, t_m, nm, h.ignore_index, clip_min)
    loss_h = _masked_level_bce_pick(_pick_channel(lc, sh), mcmc, t_h, nh, h.ignore_index, clip_min)
    return 5.0 * (loss_f + loss_m + loss_h)


def _upsample(lo: torch.Tensor, out_hw, hiera_precision: str) -> torch.Tensor:
    """The C-major low-res logits upsampled to ``out_hw``: f32 under
    ``parity``; under ``fast`` rounded to bf16 first and resized in bf16,
    as the JAX package stores them (``lo.astype(bfloat16)`` +
    ``_resize_cmajor``)."""
    if hiera_precision == "fast":
        return resize_bilinear_bf16(lo.to(torch.bfloat16), out_hw)
    return resize_bilinear(lo, out_hw)


def _not_yet_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to seghiero_torch (ROADMAP queue 1)")


class FastHieraTripletLoss:
    """``loss_weight · (5·hieraBCE + CE_fine + CE_coarse
    + ready · schedule(step) · triplet)`` from low-res logits.

    Called as ``(step, embedding, cls_score_before, cls_score, label)``
    like the JAX class: ``embedding`` ``[B, D, h', w']``, ``cls_score``
    ``[B, C, h, w]`` (``cls_score_before`` unused, as in the reference),
    ``label`` int ``[B, H, W]``. The triplet term stays in the graph
    behind the readiness ``where`` — a Python branch would leave the
    projection head without a gradient, and SGD would then skip its weight
    decay and momentum where the JAX step applies them. ``hiera_precision``
    (``parity`` or ``fast``) sets the unfused path's storage type; the fused
    kernels are f32 only, and the config refuses ``fast`` with them."""

    def __init__(self, hierarchy: Hierarchy, loss_weight: float = 1.0,
                 schedule_total_steps: int = 80_000, use_kernel: bool = False,
                 hiera_variant: str = "bce", ohem=None, selection: str = "auto",
                 hiera_precision: str = "parity"):
        if hiera_variant != "bce":
            raise _not_yet_ported(f"training.hiera_variant: {hiera_variant}")
        if ohem is not None:
            raise _not_yet_ported("OHEM (training.ohem_thresh)")
        self.h = hierarchy
        self.loss_weight = loss_weight
        self.schedule_total_steps = schedule_total_steps
        self.use_kernel = use_kernel
        self.selection = selection
        self.hiera_precision = hiera_precision

    def __call__(self, step, embedding, cls_score_before, cls_score, label):
        h = self.h
        out_hw = tuple(label.shape[1:3])
        lo = cls_score.to(torch.float32).contiguous()  # C-major, low-res
        t_fine, t_coarse = prepare_targets_two_level(label, h)
        fused = self.use_kernel and out_hw == (SCALE * lo.shape[2], SCALE * lo.shape[3])
        if self.use_kernel and not fused and lo.device.type != "cpu":
            # the CPU keeps JAX's gate (fused_hiera2_available); on the card
            # the kernels are asked for, so another ratio is an error
            raise ValueError(
                f"training.pallas_fused_loss needs labels {SCALE}x the logits' size, got "
                f"labels {out_hw} for logits {tuple(lo.shape[2:])}; set it to false")
        if fused:
            s_f, s_c, nvf, nvc, ce_f, ce_c = fused_hiera2_loss_sums(
                lo, t_fine.to(torch.int32).contiguous(),
                t_coarse.to(torch.int32).contiguous(), h)
            total = label.numel()
            loss = 5.0 * (s_f / (torch.clamp(nvf, min=1.0) * h.n_fine)
                          + s_c / (torch.clamp(nvc, min=1.0) * h.n_coarse))
            loss = loss + ce_f / total + ce_c / total
        else:
            lf = _upsample(lo, out_hw, self.hiera_precision)
            loss = hiera_bce_two_level_cmajor(lf, t_fine, t_coarse, h)
            loss = loss + _ce_cmajor(lf[:, : h.n_fine], t_fine, h.ignore_index)
            loss = loss + _ce_cmajor(lf[:, h.n_fine : h.n_fine + h.n_coarse], t_coarse,
                                     h.ignore_index)
        emb = embedding.to(torch.float32).permute(0, 2, 3, 1)  # NHWC, the JAX layout
        t, c = tree_triplet_loss_range(emb, label, h, selection=self.selection)
        factor = triplet_schedule_factor(step, self.schedule_total_steps, device=lo.device)
        ready = triplet_readiness(c)
        return (loss + torch.where(ready, factor * t, 0.0)) * self.loss_weight


class FastRMIHieraTripletLoss:
    """The 3-level composite ``loss_weight · (λ·RMI + 0.5·hieraBCE₃ + CE_fine
    + CE_mid + CE_high + ready · schedule(step) · triplet_groups)`` from
    low-res logits, called as :class:`FastHieraTripletLoss` is.

    The logits are upsampled to the label size (all ``n_fine + n_coarse +
    n_super`` channels; in bf16 under ``hiera_precision: fast``, else f32);
    RMI runs on the concatenated one-hots [fine | mid | high] against
    ``sigmoid(logits)`` (in f32) zeroed at each level's ignored pixels and
    floored at ``_CLIP_MIN``, through
    ``rmi_lower_bound_cmajor`` (``rmi_backend``: ``pallas`` = the CUDA Gram
    kernels, ``xla`` = the materialized PyTorch op or, under
    ``rmi_streaming``, its row-chunked form; ``rmi_precision: fast`` = the
    kernels' bf16-view variants). ``use_kernel``
    (``training.pallas_fused_loss``) has no 3-level kernel: the CPU ignores
    it, as the JAX package does, and the card raises."""

    def __init__(self, hierarchy: Hierarchy, rmi_radius: int = 3,
                 loss_weight_lambda: float = 0.5, loss_weight: float = 1.0,
                 upper_ids=None, lower_ids=None, use_float64: bool = False,
                 rmi_streaming: str = "auto", rmi_backend: str = "auto",
                 rmi_precision: str = "parity", hiera_variant: str = "bce", ohem=None,
                 selection: str = "auto", use_kernel: bool = False,
                 hiera_precision: str = "parity"):
        if hiera_variant != "bce":
            raise _not_yet_ported(f"training.hiera_variant: {hiera_variant}")
        if ohem is not None:
            raise _not_yet_ported("OHEM (training.ohem_thresh)")
        self.h = hierarchy
        self.rmi_radius = rmi_radius
        self.loss_weight_lambda = loss_weight_lambda
        self.loss_weight = loss_weight
        self.upper_ids = upper_ids
        self.lower_ids = lower_ids
        self.use_float64 = use_float64
        self.rmi_streaming = rmi_streaming
        self.rmi_backend = rmi_backend
        self.rmi_precision = rmi_precision
        self.selection = selection
        self.use_kernel = use_kernel
        self.hiera_precision = hiera_precision

    @property
    def schedule_total_steps(self) -> int:
        return 160_000 if self.h.n_fine > 15 else 60_000

    def __call__(self, step, embedding, cls_score_before, cls_score, label):
        h = self.h
        nf, nm, nh = h.n_fine, h.n_coarse, h.n_super
        lo = cls_score.to(torch.float32).contiguous()
        if self.use_kernel and lo.device.type != "cpu":
            raise ValueError(
                "training.pallas_fused_loss: there is no fused 3-level loss kernel "
                "(the fused loss is 2-level only); set it to false")
        lf = _upsample(lo, tuple(label.shape[1:3]), self.hiera_precision)
        t_f, t_m, t_h = prepare_targets_three_level(label, h)
        hiera = hiera_bce_three_level_cmajor(lf, t_f, t_m, t_h, h)

        probs = torch.sigmoid(lf.to(torch.float32))
        levels = [_one_hot_valid(t, n, h.ignore_index, dim=1)
                  for t, n in ((t_f, nf), (t_m, nm), (t_h, nh))]
        oh_all = torch.cat([oh for oh, _ in levels], dim=1)
        valid_all = torch.cat([v.unsqueeze(1).expand_as(oh) for oh, v in levels],
                              dim=1).to(torch.float32)
        rmi = rmi_lower_bound_cmajor(
            oh_all, probs * valid_all + _CLIP_MIN, radius=self.rmi_radius,
            use_float64=self.use_float64, streaming=self.rmi_streaming,
            backend=self.rmi_backend, precision=self.rmi_precision)
        loss = self.loss_weight_lambda * rmi + 0.5 * hiera
        loss = loss + _ce_cmajor(lf[:, :nf], t_f, h.ignore_index)
        loss = loss + _ce_cmajor(lf[:, nf : nf + nm], t_m, h.ignore_index)
        loss = loss + _ce_cmajor(lf[:, nf + nm : nf + nm + nh], t_h, h.ignore_index)

        upper, lower = ((tuple(self.upper_ids), tuple(self.lower_ids))
                        if self.upper_ids is not None else h.split_upper_lower())
        emb = embedding.to(torch.float32).permute(0, 2, 3, 1)  # NHWC, the JAX layout
        t, c = tree_triplet_loss_groups(emb, label, upper, lower, nf,
                                        ignore_index=h.ignore_index, selection=self.selection)
        factor = triplet_schedule_factor(step, self.schedule_total_steps, device=lo.device)
        ready = triplet_readiness(c)
        return (loss + torch.where(ready, factor * t, 0.0)) * self.loss_weight


def aux_ce_fast(aux_logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = 255,
                hiera_precision: str = "parity"):
    """Aux CE: the aux logits ``[B, n_fine, h, w]`` bilinearly upsampled to
    the label size (in bf16 under ``hiera_precision: fast``), CE averaged
    over valid pixels."""
    lo = aux_logits.to(torch.float32).contiguous()
    lf = _upsample(lo, tuple(labels.shape[1:3]), hiera_precision)
    return _ce_cmajor(lf, labels, ignore_index, divide_by="valid")
