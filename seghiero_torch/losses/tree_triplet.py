"""Tree-triplet embedding losses, range and group variants (the port of
``seghiero_tpu/losses/tree_triplet.py:45-402`` and the schedule/readiness
helpers ``:405-428``).

Range variant (2-level): for each fine class present, positives are
same-coarse-bucket pixels and negatives out-of-bucket pixels — including
ignore-255 pixels, as the reference's ``(labels < start) | (labels >=
end)`` admits them. Group variant (3-level): positives and negatives come
from two fine-id groups. Both use cosine distances on the L2-normalized
embedding, margin 0.6, at most 200 triplets per class. The reference's
"first ``k`` pixels of each mask" is
reproduced with fixed shapes: ``topk`` of the unique scores
``mask · (N − position)`` (the ``mask`` selection) or one stable sort of
the labels plus exact merges (the ``sorted`` selection); both pick the
same pixels as the JAX package.

Returns ``(loss, class_count)``; ``class_count == 0`` implies
``loss == 0`` — the caller's readiness gate checks the count.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from seghiero_torch.hierarchy import Hierarchy
from seghiero_torch.losses.hiera import device_table
from seghiero_torch.ops.resize import downsample_labels_nearest

# static crossover between the two selections (DESIGN decision 22)
SORTED_SELECTION_MIN_CLASSES = 16


def _first_k_selection(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first ``k`` True positions per row of ``mask`` [C, N];
    rows with fewer than k hold arbitrary trailing indices (callers mask
    lanes ``>= count``)."""
    n = mask.shape[-1]
    position = torch.arange(n, device=mask.device)
    scores = torch.where(mask, n - position, 0)
    return torch.topk(scores, k, dim=-1).indices  # descending score = ascending position


def _per_class_first_k(lbl: torch.Tensor, n_fine: int, k: int):
    """First ``k`` flat positions of every fine class from ONE stable sort
    of the labels: ``(idx [n_fine, k], counts [n_fine + 1])``; rows with
    ``counts[c] < k`` hold other classes' positions past lane ``counts[c]``."""
    n = lbl.shape[0]
    valid = (lbl >= 0) & (lbl < n_fine)
    key = torch.where(valid, lbl, n_fine).to(torch.int64)
    skey, order = torch.sort(key, stable=True)
    class_ids = torch.arange(n_fine + 2, device=lbl.device)
    bounds = torch.searchsorted(skey, class_ids)  # side="left"
    counts = bounds[1:] - bounds[:-1]
    lane = torch.arange(k, device=lbl.device)
    at = torch.clamp(bounds[:n_fine, None] + lane[None, :], max=n - 1)
    return order[at], counts


def _member_rows(rows: Sequence[Sequence[int]], width: int) -> tuple:
    """``rows`` padded with -1 to ``width`` columns, as a tuple of tuples
    (``_merged_first_k``'s table)."""
    return tuple(tuple(r) + (-1,) * (width - len(r)) for r in rows)


def _merged_first_k(idx_by_class, counts, member_rows: tuple, k: int, n: int):
    """First ``k`` flat positions of a UNION of per-class first-k lists
    (exact: a position among the k smallest of the union is among the k
    smallest of its own class). ``member_rows``: each row's classes,
    padded with -1 (``_member_rows``)."""
    dev = idx_by_class.device
    safe = device_table(tuple(tuple(max(c, 0) for c in r) for r in member_rows), torch.int64,
                        dev)
    cand = idx_by_class[safe]  # [C, m, k]
    lane = torch.arange(k, device=dev)
    present = device_table(tuple(tuple(c >= 0 for c in r) for r in member_rows), torch.bool,
                           dev)
    cand_valid = (lane[None, None, :] < counts[safe][:, :, None]) & present[:, :, None]
    merged = torch.where(cand_valid, cand, n).reshape(len(member_rows), -1)
    sel = torch.topk(merged, k, dim=-1, largest=False).values  # ascending
    return torch.clamp(sel, max=n - 1)


def _spread_padding(idx: torch.Tensor, lane_valid: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` [C, k] with every lane outside ``lane_valid`` sent to row
    ``(c·k + lane) mod n``, so that no row takes more than ``⌈C·k/n⌉``
    of them."""
    spread = torch.arange(idx.numel(), device=idx.device).view_as(idx) % n
    return torch.where(lane_valid, idx, spread)


def _triplet_from_indices(feats, idx_a, idx_p, idx_n, min_size, max_triplet: int,
                          margin: float) -> Tuple[torch.Tensor, torch.Tensor]:
    lane = torch.arange(max_triplet, device=feats.device)[None, :]
    lane_valid = lane < min_size[:, None]
    # Lanes past min_size are masked out below, so their gradient is zero.
    # The selections point most of them at one row, whose sorted accumulate
    # in the gathers' backward would add them one after another: spread them.
    fa, fp, fn = (feats[_spread_padding(i, lane_valid, feats.shape[0])]
                  for i in (idx_a, idx_p, idx_n))  # [C, k, D]
    d_pos = 1.0 - (fa * fp).sum(-1)
    d_neg = 1.0 - (fa * fn).sum(-1)
    tl = torch.relu(d_pos - d_neg + margin)
    per_class = torch.where(lane_valid, tl, 0.0).sum(-1) / torch.clamp(
        min_size.to(torch.float32), min=1.0)
    has = min_size > 0
    class_count = has.sum()
    loss = torch.where(has, per_class, 0.0).sum() / torch.clamp(
        class_count.to(torch.float32), min=1.0)
    return loss, class_count


def _triplet_core(feats, anchor, pos, neg, max_triplet: int, margin: float):
    """Mask-based selection (one topk row per class and mask)."""
    max_triplet = min(max_triplet, anchor.shape[-1])
    min_size = torch.minimum(
        torch.minimum(anchor.sum(-1), pos.sum(-1)),
        torch.clamp(neg.sum(-1), max=max_triplet),
    )
    return _triplet_from_indices(
        feats,
        _first_k_selection(anchor, max_triplet),
        _first_k_selection(pos, max_triplet),
        _first_k_selection(neg, max_triplet),
        min_size, max_triplet, margin,
    )


def tree_triplet_loss_range(
    embedding: torch.Tensor,  # [B, h, w, D], L2-normalized over D
    labels: torch.Tensor,  # [B, H, W] fine ids or 255
    hierarchy: Hierarchy,
    *,
    max_triplet: int = 200,
    margin: float = 0.6,
    selection: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Range variant (tree_triplet_loss.py:6-65 of the reference).
    ``selection``: ``"mask"`` (per-class topk rows), ``"sorted"`` (one
    stable sort + bucket merges; the same pixels), or ``"auto"``."""
    if hierarchy.coarse_ranges is None:
        raise ValueError(
            "range-variant triplet loss requires contiguous coarse buckets; "
            "use tree_triplet_loss_groups for general hierarchies"
        )
    B, h, w, D = embedding.shape
    lbl = downsample_labels_nearest(labels, (h, w)).reshape(-1)
    feats = embedding.reshape(-1, D)
    n_fine = hierarchy.n_fine
    dev = lbl.device
    if selection == "auto":
        selection = "sorted" if n_fine >= SORTED_SELECTION_MIN_CLASSES else "mask"
    f2c = tuple(int(c) for c in hierarchy.fine_to_coarse)

    if selection == "mask":
        starts = device_table(tuple(int(hierarchy.coarse_ranges[c][0]) for c in f2c),
                              torch.int64, dev)
        ends = device_table(tuple(int(hierarchy.coarse_ranges[c][1]) for c in f2c),
                            torch.int64, dev)
        lblr = lbl[None, :]
        anchor = lblr == torch.arange(n_fine, device=dev)[:, None]
        in_bucket = (lblr >= starts[:, None]) & (lblr < ends[:, None])
        return _triplet_core(feats, anchor, in_bucket & ~anchor, ~in_bucket,
                             max_triplet, margin)

    if selection != "sorted":
        raise ValueError(f"selection must be auto|mask|sorted, got {selection!r}")
    n = lbl.shape[0]
    k = min(max_triplet, n)
    f2c_t = device_table(f2c, torch.int64, dev)
    idx_by_class, counts = _per_class_first_k(lbl, n_fine, k)
    bucket_totals = torch.zeros(hierarchy.n_coarse, dtype=counts.dtype, device=dev)
    bucket_totals.index_add_(0, f2c_t, counts[:n_fine])
    n_anchor = counts[:n_fine]
    n_pos = bucket_totals[f2c_t] - n_anchor
    n_neg = n - bucket_totals[f2c_t]
    min_size = torch.minimum(torch.minimum(n_anchor, n_pos), torch.clamp(n_neg, max=k))

    max_b = max(len(m) for m in hierarchy.fine_by_coarse)
    member_rows = _member_rows([[int(p) for p in hierarchy.fine_by_coarse[f2c[c]] if p != c]
                                for c in range(n_fine)], max(max_b - 1, 1))
    idx_p = _merged_first_k(idx_by_class, counts, member_rows, k, n)

    bstarts = device_table(tuple(int(r[0]) for r in hierarchy.coarse_ranges), torch.int64, dev)
    bends = device_table(tuple(int(r[1]) for r in hierarchy.coarse_ranges), torch.int64, dev)
    neg_mask = ~((lbl[None, :] >= bstarts[:, None]) & (lbl[None, :] < bends[:, None]))
    idx_n = _first_k_selection(neg_mask, k)[f2c_t]
    return _triplet_from_indices(feats, idx_by_class, idx_p, idx_n, min_size, k, margin)


def tree_triplet_loss_groups(
    embedding: torch.Tensor,  # [B, h, w, D], L2-normalized over D
    labels: torch.Tensor,  # [B, H, W] fine ids or 255
    upper_ids: Sequence[int],
    lower_ids: Sequence[int],
    n_fine: int,
    *,
    ignore_index: int = 255,
    max_triplet: int = 200,
    margin: float = 0.6,
    selection: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group variant (rmi_tree_triplet_loss.py:5-70 of the reference): for an
    anchor class in ``upper_ids`` the positives are the other upper ids and
    the negatives the lower ids, and vice versa; classes in neither group
    (background 0 among them) contribute nothing. ``selection`` as in
    :func:`tree_triplet_loss_range`; the sorted path merges the per-class
    lists of a group (one shared negative row per group)."""
    B, h, w, D = embedding.shape
    lbl = downsample_labels_nearest(labels, (h, w)).reshape(-1)
    feats = embedding.reshape(-1, D)
    dev = lbl.device
    upper = sorted(int(i) for i in upper_ids)
    lower = sorted(int(i) for i in lower_ids)
    # checked here for both selections: an index gather would clamp silently
    bad = [i for i in upper + lower if not 0 <= i < n_fine]
    if bad:
        raise ValueError(f"triplet group ids out of range [0, {n_fine}): {sorted(bad)}")
    listed = upper + lower
    if not listed:
        return (torch.zeros((), dtype=torch.float32, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    C = len(listed)
    if selection == "auto":
        selection = "sorted" if C >= SORTED_SELECTION_MIN_CLASSES else "mask"

    if selection == "mask":
        pos_lut, neg_lut = [], []
        for c in listed:
            group, other = (upper, lower) if c in upper else (lower, upper)
            pos_lut.append(tuple(p in group and p != c for p in range(n_fine)))
            neg_lut.append(tuple(p in other for p in range(n_fine)))
        valid = (lbl >= 0) & (lbl < n_fine) & (lbl != ignore_index)
        safe = torch.where(valid, lbl, 0).long()
        listed_t = device_table(tuple(listed), torch.int64, dev)
        anchor = (lbl[None, :] == listed_t[:, None]) & valid[None, :]
        pos = device_table(tuple(pos_lut), torch.bool, dev)[:, safe] & valid[None, :]
        neg = device_table(tuple(neg_lut), torch.bool, dev)[:, safe] & valid[None, :]
        return _triplet_core(feats, anchor, pos, neg, max_triplet, margin)

    if selection != "sorted":
        raise ValueError(f"selection must be auto|mask|sorted, got {selection!r}")
    n = lbl.shape[0]
    k = min(max_triplet, n)
    # ignore_index into the invalid bucket even if it were < n_fine
    lbl_sel = torch.where(lbl == ignore_index, n_fine, lbl)
    idx_by_class, counts = _per_class_first_k(lbl_sel, n_fine, k)
    group_of = device_table(tuple(0 if c in upper else 1 for c in listed), torch.int64, dev)
    zero = torch.zeros((), dtype=counts.dtype, device=dev)
    group_sum = torch.stack(
        [counts[device_table(tuple(upper), torch.int64, dev)].sum() if upper else zero,
         counts[device_table(tuple(lower), torch.int64, dev)].sum() if lower else zero])
    listed_t = device_table(tuple(listed), torch.int64, dev)
    n_anchor = counts[listed_t]
    n_pos = group_sum[group_of] - n_anchor
    n_neg = group_sum[1 - group_of]
    min_size = torch.minimum(torch.minimum(n_anchor, n_pos), torch.clamp(n_neg, max=k))
    idx_a = idx_by_class[listed_t]

    # positives: the own group's per-class lists merged, the own class left out
    m = max(max(len(upper), len(lower)) - 1, 1)
    member_rows = _member_rows([[p for p in (upper if c in upper else lower) if p != c]
                                for c in listed], m)
    idx_p = _merged_first_k(idx_by_class, counts, member_rows, k, n)

    # negatives: one shared row per group (the first k of the other group):
    # anchors in upper draw from lower, and vice versa
    neg_rows = _member_rows([lower, upper], max(len(upper), len(lower), 1))
    idx_n = _merged_first_k(idx_by_class, counts, neg_rows, k, n)[group_of]
    return _triplet_from_indices(feats, idx_a, idx_p, idx_n, min_size, k, margin)


def triplet_schedule_factor(step, total_steps: int, device=None) -> torch.Tensor:
    """Cosine ramp of the triplet weight: ``0.25·(1 + cos((step − T)/T·π))``
    before ``T`` steps, else 0.5 — in f32, as a 0-dim tensor. ``step`` is a
    Python int or a 0-dim tensor on ``device`` (the train step's, which it
    writes before each step without a host sync): the same value either way."""
    s = torch.as_tensor(step, dtype=torch.float32, device=device)
    t = float(total_steps)
    ramp = 0.25 * (1.0 + torch.cos((s - t) / t * math.pi))
    return torch.where(s < t, ramp, torch.full_like(ramp, 0.5))


def triplet_readiness(class_count: torch.Tensor) -> torch.Tensor:
    """``class_count > 0`` (one replica; the JAX package's cross-replica
    ``pmin`` waits for multi-GPU training)."""
    return class_count > 0
