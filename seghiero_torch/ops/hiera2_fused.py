"""Fused 4× bilinear upsample + 2-level hierarchy BCE + per-level CE — the
port of ``seghiero_tpu/ops/pallas/hiera2_fused.py``.

``fused_hiera2_loss_sums(lo, t_fine, t_coarse, hierarchy)`` returns the six
raw sums ``(s_f, s_c, nv_f, nv_c, ce_f, ce_c)`` of the 2-level hierarchy
BCE and CE terms over the 4×-upsampled logits; the caller assembles the
loss (``losses/fast.py``). It is a ``torch.autograd.Function``: forward
``csrc/hiera2_fused.cu`` ``seghiero_hiera2_fwd`` (kernel #4), backward
``seghiero_hiera2_bwd`` (kernel #5) for tensors on the card, and the plain
versions below for tensors on the CPU; any other device raises.

Layouts are the JAX ones: C-major f32 logits ``[B, C, h, w]``, int32
labels ``[B, 4h, 4w]`` with 255 = ignore. The kernels take any 2-level
hierarchy (:func:`hierarchy_table` is their view of it) of up to 65535
channels (their channel ids take 16 bits; the C entries refuse more).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from seghiero_torch.hierarchy import Hierarchy
from seghiero_torch.losses.hiera import _log_one_minus_sig_eps, _log_sig_eps
from seghiero_torch.losses.hiera import softplus as _softplus
from seghiero_torch.ops import _build
from seghiero_torch.ops.upsample_argmax import PHASE, SCALE

LOG_EPS = float(np.log(1e-8))  # the 2-level BCE eps (hiera_triplet_loss.py:46)
IGNORE = 255

# kernel launches in this process (set to 0 to count a run)
fwd_launches = 0
bwd_launches = 0
COUNTERS = ("fwd_launches", "bwd_launches")

_table_cache: Dict[Tuple[torch.device, Tuple[int, ...]], torch.Tensor] = {}


# ---------------------------------------------------------------------------
# plain versions: the kernels' per-pixel arithmetic in PyTorch
def upsample4_plain(lo: torch.Tensor) -> torch.Tensor:
    """``[B, C, h, w]`` → ``[B, C, 4h, 4w]`` f32 by the kernels' 16-phase
    blend ``ay·(ax·t00 + bx·t01) + by·(ax·t10 + bx·t11)`` over the
    edge-padded logits — the same f32 operations in the same order as the
    kernels, so the same bits."""
    B, C, h, w = lo.shape
    lp = F.pad(lo.to(torch.float32), (1, 1, 1, 1), mode="replicate")
    views = [lp[:, :, r : r + h, c : c + w] for r in range(3) for c in range(3)]
    out = torch.empty((B, C, h, SCALE, w, SCALE), dtype=torch.float32, device=lo.device)
    for py, (ro, ay, by) in enumerate(PHASE):
        for px, (co, ax, bx) in enumerate(PHASE):
            t00, t01 = views[ro * 3 + co], views[ro * 3 + co + 1]
            t10, t11 = views[(ro + 1) * 3 + co], views[(ro + 1) * 3 + co + 1]
            out[:, :, :, py, :, px] = ay * (ax * t00 + bx * t01) + by * (ax * t10 + bx * t11)
    return out.reshape(B, C, SCALE * h, SCALE * w)


def _logaddexp_eps(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.full_like(x, LOG_EPS))


def _wu(u):  # exp(u − logaddexp(u, log ε)), the TPU kernel's form
    return torch.exp(u - _logaddexp_eps(u))


def _split(lf: torch.Tensor, hierarchy: Hierarchy):
    nf = hierarchy.n_fine
    return lf[:, :nf], lf[:, nf : nf + hierarchy.n_coarse]


def _labels(t: torch.Tensor, n: int, ignore: int = IGNORE):
    """(valid [B,H,W], one-hot [B,n,H,W]) of a label map."""
    cls = torch.arange(n, device=t.device).view(1, n, 1, 1)
    return t != ignore, t.unsqueeze(1) == cls


def _bucket_first_max(la, lb, hierarchy: Hierarchy):
    """Per coarse channel: the bucket max over (own, children in id order)
    and the index of its first maximum (-1 = the own channel)."""
    mxs, wins = [], []
    for ci, ids in enumerate(hierarchy.fine_by_coarse):
        mx = lb[:, ci]
        win = torch.full_like(mx, -1, dtype=torch.int64)
        for f in ids:
            take = la[:, f] > mx  # strict: the first maximum wins
            win = torch.where(take, f, win)
            mx = torch.maximum(mx, la[:, f])
        mxs.append(mx)
        wins.append(win)
    return torch.stack(mxs, 1), torch.stack(wins, 1)


def fused_hiera2_sums_plain(lo, t_fine, t_coarse, hierarchy: Hierarchy) -> torch.Tensor:
    """The six sums as one f32 tensor ``[6]``, by the forward kernel's
    per-pixel formulas over the plain upsample."""
    lf = upsample4_plain(lo)
    la, lb = _split(lf, hierarchy)
    nf, nc = hierarchy.n_fine, hierarchy.n_coarse
    f2c = torch.as_tensor(np.asarray(hierarchy.fine_to_coarse, np.int64), device=lo.device)
    vf, ohf = _labels(t_fine, nf)
    vc, ohc = _labels(t_coarse, nc)
    # fine BCE: the positive through min(l_f, l_coarse(f)) at the label
    term_f = torch.where(ohf, -_log_sig_eps(torch.minimum(la, lb[:, f2c])),
                         -_log_one_minus_sig_eps(la))
    s_f = torch.where(vf, term_f.sum(1), 0.0).sum()
    # coarse BCE: the negative through the bucket max
    mcmb, _ = _bucket_first_max(la, lb, hierarchy)
    term_c = torch.where(ohc, -_log_sig_eps(lb), -_log_one_minus_sig_eps(mcmb))
    s_c = torch.where(vc, term_c.sum(1), 0.0).sum()

    def ce(l, oh, valid):
        mx = l.max(1).values
        se = torch.exp(l - mx.unsqueeze(1)).sum(1)
        picked = torch.where(oh, l, 0.0).sum(1)
        return torch.where(valid, torch.log(se) + mx - picked, 0.0).sum()

    return torch.stack([s_f, s_c, vf.sum().float(), vc.sum().float(),
                        ce(la, ohf, vf), ce(lb, ohc, vc)])


def fused_hiera2_grad_plain(lo, t_fine, t_coarse, hierarchy: Hierarchy,
                            g: torch.Tensor) -> torch.Tensor:
    """d lo ``[B, C, h, w]`` f32 for the cotangents ``g [6]`` of the six
    sums, by the backward kernel's routing written out (no autograd:
    ``torch.minimum``'s gradient would split ties in half): the fine
    positive goes wholly to the fine channel when ``l_f <= l_coarse``, the
    coarse negative to the first maximum of (own, children in id order),
    CE is softmax − one-hot; then scattered through the 4 taps and the
    edge clamp."""
    B, C, h, w = lo.shape
    lf = upsample4_plain(lo)
    la, lb = _split(lf, hierarchy)
    nf, nc = hierarchy.n_fine, hierarchy.n_coarse
    g_sf, g_sc, g_cef, g_cec = g[0], g[1], g[4], g[5]
    f2c = torch.as_tensor(np.asarray(hierarchy.fine_to_coarse, np.int64), device=lo.device)
    vf, ohf = _labels(t_fine, nf)
    vc, ohc = _labels(t_coarse, nc)
    vf1, vc1 = vf.unsqueeze(1), vc.unsqueeze(1)
    dla = torch.zeros_like(la)
    dlb = torch.zeros_like(lb)

    # fine BCE
    lpar = lb[:, f2c]
    m = torch.minimum(la, lpar)
    gpos = torch.where(ohf & vf1, -_wu(-_softplus(-m)) * torch.sigmoid(-m), 0.0) * g_sf
    take_f = la <= lpar
    dla += torch.where(take_f, gpos, 0.0)
    to_parent = torch.where(take_f, 0.0, gpos)
    dlb.index_add_(1, f2c, to_parent)
    dla += torch.where(~ohf & vf1, _wu(-_softplus(la)) * torch.sigmoid(la), 0.0) * g_sf

    # coarse BCE
    dlb += torch.where(ohc & vc1, -_wu(-_softplus(-lb)) * torch.sigmoid(-lb), 0.0) * g_sc
    mcmb, win = _bucket_first_max(la, lb, hierarchy)
    rem = torch.where(~ohc & vc1, _wu(-_softplus(mcmb)) * torch.sigmoid(mcmb), 0.0) * g_sc
    dlb += torch.where(win < 0, rem, 0.0)
    for ci in range(nc):
        for f in hierarchy.fine_by_coarse[ci]:
            dla[:, f] += torch.where(win[:, ci] == f, rem[:, ci], 0.0)

    # CE: softmax − one-hot
    dla += torch.where(vf1, torch.softmax(la, 1) - ohf.float(), 0.0) * g_cef
    dlb += torch.where(vc1, torch.softmax(lb, 1) - ohc.float(), 0.0) * g_cec

    # through the 4 taps of each phase onto the edge-padded grid, then the
    # edge clamp folds the pad back onto the border
    dl = torch.cat([dla, dlb], 1).reshape(B, C, h, SCALE, w, SCALE)
    dp = torch.zeros((B, C, h + 2, w + 2), dtype=torch.float32, device=lo.device)
    for py, (ro, ay, by) in enumerate(PHASE):
        for px, (co, ax, bx) in enumerate(PHASE):
            gp = dl[:, :, :, py, :, px]
            dp[:, :, ro : ro + h, co : co + w] += ay * ax * gp
            dp[:, :, ro : ro + h, co + 1 : co + 1 + w] += ay * bx * gp
            dp[:, :, ro + 1 : ro + 1 + h, co : co + w] += by * ax * gp
            dp[:, :, ro + 1 : ro + 1 + h, co + 1 : co + 1 + w] += by * bx * gp
    dp[:, :, 1] += dp[:, :, 0]
    dp[:, :, -2] += dp[:, :, -1]
    dp[:, :, :, 1] += dp[:, :, :, 0]
    dp[:, :, :, -2] += dp[:, :, :, -1]
    return dp[:, :, 1:-1, 1:-1].contiguous()


# ---------------------------------------------------------------------------
# kernel wrappers
def hierarchy_table(hierarchy: Hierarchy) -> np.ndarray:
    """The kernels' int32 view of the hierarchy (csrc/hiera2_fused.cu):
    ``goff [nc + 1]`` (where coarse group g starts in the walk),
    ``walk [C]`` (each group's coarse channel ``nf + g``, then its fine
    children in id order) and ``bsched [2C]`` (each group's walk entries
    twice: the backward's two passes over it)."""
    nf = hierarchy.n_fine
    groups = [[nf + g, *ids] for g, ids in enumerate(hierarchy.fine_by_coarse)]
    goff = np.cumsum([0] + [len(grp) for grp in groups])
    walk = [c for grp in groups for c in grp]
    bsched = [c for grp in groups for c in grp + grp]
    return np.concatenate([goff, walk, bsched]).astype(np.int32)


def _table_on(device: torch.device, hierarchy: Hierarchy) -> torch.Tensor:
    key = (device, tuple(int(c) for c in hierarchy.fine_to_coarse))
    if key not in _table_cache:
        _table_cache[key] = torch.from_numpy(hierarchy_table(hierarchy)).to(device)
    return _table_cache[key]


def _check(lo, t_fine, t_coarse, hierarchy: Hierarchy) -> Tuple[int, int, int, int]:
    if lo.device.type != "cuda":
        raise ValueError(f"fused_hiera2 runs on cuda or cpu tensors, got {lo.device}")
    if lo.ndim != 4 or lo.dtype != torch.float32 or not lo.is_contiguous():
        raise ValueError(
            "fused_hiera2 needs contiguous C-major f32 logits [B, C, h, w], got "
            f"{tuple(lo.shape)} {lo.dtype} contiguous={lo.is_contiguous()}; refusing to copy"
        )
    B, C, h, w = lo.shape
    nf, nc = hierarchy.n_fine, hierarchy.n_coarse
    if C != nf + nc:
        raise ValueError(f"fused_hiera2 takes {nf} + {nc} = C channels; got C={C}")
    for t in (t_fine, t_coarse):
        if (tuple(t.shape) != (B, SCALE * h, SCALE * w) or t.dtype != torch.int32
                or t.device != lo.device or not t.is_contiguous()):
            raise ValueError(
                f"labels must be contiguous int32 [B, 4h, 4w] = {(B, SCALE * h, SCALE * w)} "
                f"on {lo.device}, got {tuple(t.shape)} {t.dtype} {t.device}"
            )
    return B, C, h, w


def fused_hiera2_sums_kernel(lo, t_fine, t_coarse, hierarchy: Hierarchy) -> torch.Tensor:
    """Kernel #4: the six sums ``[6]`` f32 on the card."""
    B, C, h, w = _check(lo, t_fine, t_coarse, hierarchy)
    lib = _build.library()
    n_partial = lib.seghiero_hiera2_fwd_partials(B, h, w)
    if n_partial < 0:
        raise ValueError(f"fused_hiera2: logits {tuple(lo.shape)} past the kernel's limits")
    partial = torch.empty((max(n_partial, 1), 6), dtype=torch.float32, device=lo.device)
    sums = torch.empty((6,), dtype=torch.float32, device=lo.device)
    err = lib.seghiero_hiera2_fwd(
        lo.data_ptr(), t_fine.data_ptr(), t_coarse.data_ptr(),
        _table_on(lo.device, hierarchy).data_ptr(), partial.data_ptr(), sums.data_ptr(),
        B, C, h, w, hierarchy.n_fine, hierarchy.n_coarse, n_partial, lo.device.index,
        torch.cuda.current_stream(lo.device).cuda_stream,
    )
    _build.check(lib, err, "hiera2_fused forward")
    global fwd_launches
    fwd_launches += 1
    return sums


def fused_hiera2_grad_kernel(lo, t_fine, t_coarse, hierarchy: Hierarchy,
                             g: torch.Tensor) -> torch.Tensor:
    """Kernel #5: d lo ``[B, C, h, w]`` f32 on the card for cotangents
    ``g [6]`` (f32, on the card)."""
    B, C, h, w = _check(lo, t_fine, t_coarse, hierarchy)
    g = g.to(torch.float32).contiguous()
    if tuple(g.shape) != (6,) or g.device != lo.device:
        raise ValueError(f"cotangents must be [6] on {lo.device}, got {tuple(g.shape)}")
    dlo = torch.empty_like(lo)
    lib = _build.library()
    err = lib.seghiero_hiera2_bwd(
        lo.data_ptr(), t_fine.data_ptr(), t_coarse.data_ptr(),
        _table_on(lo.device, hierarchy).data_ptr(), g.data_ptr(), dlo.data_ptr(),
        B, C, h, w, hierarchy.n_fine, hierarchy.n_coarse, lo.device.index,
        torch.cuda.current_stream(lo.device).cuda_stream,
    )
    _build.check(lib, err, "hiera2_fused backward")
    global bwd_launches
    bwd_launches += 1
    return dlo


class _FusedHiera2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lo, t_fine, t_coarse, hierarchy):
        ctx.save_for_backward(lo, t_fine, t_coarse)
        ctx.hierarchy = hierarchy
        if _build.on_card(lo, "fused_hiera2"):
            return fused_hiera2_sums_kernel(lo, t_fine, t_coarse, hierarchy)
        return fused_hiera2_sums_plain(lo, t_fine, t_coarse, hierarchy)

    @staticmethod
    def backward(ctx, g):
        lo, t_fine, t_coarse = ctx.saved_tensors
        if _build.on_card(lo, "fused_hiera2"):
            dlo = fused_hiera2_grad_kernel(lo, t_fine, t_coarse, ctx.hierarchy, g)
        else:
            dlo = fused_hiera2_grad_plain(lo, t_fine, t_coarse, ctx.hierarchy, g)
        return dlo, None, None, None


def fused_hiera2_loss_sums(lo: torch.Tensor, t_fine: torch.Tensor, t_coarse: torch.Tensor,
                           hierarchy: Hierarchy) -> Tuple[torch.Tensor, ...]:
    """``(s_f, s_c, nv_f, nv_c, ce_f, ce_c)``: raw sums of the 2-level
    hierarchy-BCE and CE terms over the 4×-upsampled logits, differentiable
    in ``lo`` (the counts carry no gradient). ``lo`` is C-major f32
    ``[B, C, h, w]``; labels int32 ``[B, 4h, 4w]``. On the card all three
    must be contiguous (the wrapper raises instead of copying)."""
    _build.on_card(lo, "fused_hiera2")
    return tuple(_FusedHiera2.apply(lo, t_fine, t_coarse, hierarchy).unbind(0))
