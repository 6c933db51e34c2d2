"""The RMI lower bound in C-major layout (the port of
``seghiero_tpu/losses/rmi.py:54-238`` and of ``rmi_lower_bound_cmajor``,
``seghiero_tpu/losses/fast.py:283-414``).

Per class, RMI treats each 3×3 (radius × radius) neighbourhood of the
one-hot target and the probability map as a pair of vectors and adds
``0.5·logdet`` of the conditional covariance, averaged over the batch
and divided by radius². The f32 numerics are the JAX package's: the
N-normalization, the residual (PSD-by-construction) Gram and the
noise-aware jitter floor (DESIGN decision 4).

``backend``: ``"xla"`` is the materialized PyTorch op ``_rmi_logdet_core``
(the ``[B, C, r², N]`` neighbourhood tensor, autograd); ``"pallas"`` the
port's CUDA kernels (``ops/rmi_gram.py``; their plain versions on the
CPU); ``"auto"`` the kernels where they apply (radius 3, f32, on the
card) and the op elsewhere. ``precision`` (``"parity"`` or ``"fast"``:
bf16 views) reaches the kernels only, as in JAX. ``streaming`` replaces
the materialized op by ``rmi_logdet_streaming_cmajor`` (the same Grams
accumulated over row chunks) under JAX's rule: ``"on"``, or ``"auto"``
above 1.5 GB of views, and only where the rows split into chunks of at
least 8.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from seghiero_torch.ops.rmi_gram import (
    _EPS_REL,
    _POS_ALPHA,
    _check_precision,
    _half_logdet,
    _regression,
    rmi_gram_kernel_available,
    rmi_logdet_kernel_cmajor,
)

_CLIP_MIN = 1e-6  # rmi_hiera_triplet_loss.py:16 of the reference
__all__ = ["_CLIP_MIN", "_POS_ALPHA", "_rmi_logdet_core", "rmi_logdet_streaming_cmajor",
           "rmi_lower_bound_cmajor", "rmi_route"]

# the JAX package streams the Grams over row chunks above this size of the
# neighbourhood tensor (losses/fast.py:393-399)
STREAMING_BYTES = 1536 * 2**20


def _rmi_logdet_core(la: torch.Tensor, pr: torch.Tensor, half_d: int,
                     use_float64: bool) -> torch.Tensor:
    """Per-(batch, class) ``0.5·logdet`` ``[B, C]`` f32 from the neighbourhood
    vectors ``la`` (no gradient) and ``pr``, both ``[B, C, d, N]``: scaled by
    1/√N before the products, W solved from the jittered probability
    covariance, the residual ``r = la − Wᵀ·pr`` formed, and the jittered
    residual Gram's Cholesky. In f64 (``use_float64``) the reference's
    exact jitter α/N is kept. ``solve_ex`` and ``cholesky_ex`` keep the host
    out of the step: a bad batch gives non-finite values, as in JAX."""
    dt = torch.float64 if use_float64 else torch.float32
    n = la.shape[-1]
    scale = float(1.0 / np.sqrt(n))
    la = la.to(dt) * scale
    pr = pr.to(dt) * scale
    eps_rel = 0.0 if use_float64 else _EPS_REL
    pr_cov = torch.einsum("bcin,bcjn->bcij", pr, pr)
    la_pr = torch.einsum("bcin,bcjn->bcij", la, pr)
    w = _regression(pr_cov, la_pr, n, eps_rel)
    r = la - torch.einsum("bcji,bcjn->bcin", w, pr)  # residual vectors
    return _half_logdet(torch.einsum("bcin,bcjn->bcij", r, r), n, eps_rel)  # a Gram: PSD


def _pick_chunk_rows(nh: int, target: int = 64) -> int:
    """Largest divisor of ``nh`` that is ≤ ``target`` (the JAX package's
    static chunk shape)."""
    best = 1
    for d in range(1, min(nh, target) + 1):
        if nh % d == 0:
            best = d
    return best


def rmi_logdet_streaming_cmajor(oh_map: torch.Tensor, pr_map: torch.Tensor, *, radius: int = 3,
                                use_float64: bool = False,
                                target_rows: int = 64) -> torch.Tensor:
    """Per-(batch, class) ``0.5·logdet`` ``[B, C]`` with the numerics of
    ``_rmi_logdet_core`` and O(chunk) activation memory: the Grams are
    accumulated over chunks of ``_pick_chunk_rows(nh, target_rows)`` output
    rows, each read from a ``(rows + radius − 1)``-row band of the maps, in
    two passes — ``pr_cov`` and ``la_pr``, the solve for W, then the
    residual Gram ``Σ_chunks r·rᵀ`` (a sum of Gram matrices, so PSD by
    construction). Each chunk runs under ``torch.utils.checkpoint``, the
    counterpart of JAX's ``jax.checkpoint`` scan body: the backward
    recomputes one chunk's views at a time instead of keeping them all."""
    dt = torch.float64 if use_float64 else torch.float32
    B, C, H, W = pr_map.shape
    r, d = radius, radius * radius
    nh, nw = H - (r - 1), W - (r - 1)
    n = nh * nw
    rows = _pick_chunk_rows(nh, target_rows)
    scale = float(1.0 / np.sqrt(n))
    oh_map = oh_map.detach().to(dt)
    pr_map = pr_map.to(dt)

    def views(m, row0):
        """``[B, C, d, rows·nw]`` neighbourhood vectors of output rows
        ``[row0, row0 + rows)``, scaled by 1/√N."""
        band = m[:, :, row0 : row0 + rows + r - 1]
        vs = [band[:, :, y : y + rows, x : x + nw] for y in range(r) for x in range(r)]
        return torch.stack(vs, dim=2).reshape(B, C, d, rows * nw) * scale

    def grams(pr_m, row0):
        la, pr = views(oh_map, row0), views(pr_m, row0)
        return (torch.einsum("bcin,bcjn->bcij", pr, pr),
                torch.einsum("bcin,bcjn->bcij", la, pr))

    def residual_gram(pr_m, w, row0):
        res = views(oh_map, row0) - torch.einsum("bcji,bcjn->bcin", w, views(pr_m, row0))
        return torch.einsum("bcin,bcjn->bcij", res, res)

    row0s = range(0, nh, rows)
    eps_rel = 0.0 if use_float64 else _EPS_REL
    pr_cov = la_pr = torch.zeros((B, C, d, d), dtype=dt, device=pr_map.device)
    for row0 in row0s:
        g_pr, g_la = checkpoint(grams, pr_map, row0, use_reentrant=False)
        pr_cov, la_pr = pr_cov + g_pr, la_pr + g_la
    w = _regression(pr_cov, la_pr, n, eps_rel)
    appro_var = torch.zeros_like(pr_cov)
    for row0 in row0s:
        appro_var = appro_var + checkpoint(residual_gram, pr_map, w, row0, use_reentrant=False)
    return _half_logdet(appro_var, n, eps_rel)


def rmi_route(shape, radius: int, use_float64: bool, streaming: str, backend: str,
              device: torch.device) -> str:
    """Which path ``rmi_lower_bound_cmajor`` takes for maps of ``shape``
    ``[B, C, H, W]``: ``"kernels"`` (``ops/rmi_gram.py``), ``"streaming"``
    or ``"materialized"`` — JAX's decision (``losses/fast.py:318-399``), so
    one YAML takes the same path in both packages; but ``auto`` takes the
    kernels only at shapes their launch takes (``kernel_shape_ok``: more
    maps or larger maps fall through to streaming or the materialized op,
    where JAX's Pallas kernel computes a value)."""
    B, C, H, W = shape
    nh, nw = H - (radius - 1), W - (radius - 1)
    if backend == "pallas" or (backend == "auto" and rmi_gram_kernel_available(
            B * C, H, W, radius, use_float64, device)):
        return "kernels"
    if (streaming == "on" or (streaming == "auto"
                              and B * C * radius * radius * nh * nw * 4 > STREAMING_BYTES)) \
            and _pick_chunk_rows(nh) >= 8:
        return "streaming"
    return "materialized"


def rmi_lower_bound_cmajor(oh_all: torch.Tensor, probs_masked: torch.Tensor, *,
                           radius: int = 3, use_float64: bool = False,
                           streaming: str = "auto", backend: str = "auto",
                           precision: str = "parity") -> torch.Tensor:
    """RMI summed over classes (a scalar) from the one-hot targets and the
    masked probabilities, both ``[B, C, H, W]``."""
    _check_precision(precision)
    half_d = radius * radius
    B, C, H, W = probs_masked.shape
    nh, nw = H - (radius - 1), W - (radius - 1)
    if backend == "pallas":
        # fail loudly instead of computing radius-3/f32 statistics for
        # another configuration
        if radius != 3:
            raise ValueError(
                "training.rmi_backend: pallas requires rmi_radius == 3 "
                f"(got {radius}); use rmi_backend: auto or xla"
            )
        if use_float64:
            raise ValueError(
                "training.rmi_backend: pallas is f32-only; disable "
                "rmi_use_float64 or use rmi_backend: auto or xla"
            )
    route = rmi_route(probs_masked.shape, radius, use_float64, streaming, backend,
                      probs_masked.device)
    if route == "kernels":
        half = rmi_logdet_kernel_cmajor(oh_all, probs_masked, precision)
    elif route == "streaming":
        half = rmi_logdet_streaming_cmajor(oh_all, probs_masked, radius=radius,
                                           use_float64=use_float64)
    else:
        def nbhd(x):
            views = [x[:, :, y : y + nh, xx : xx + nw] for y in range(radius)
                     for xx in range(radius)]
            return torch.stack(views, dim=2).reshape(B, C, half_d, nh * nw)

        half = _rmi_logdet_core(nbhd(oh_all).detach(), nbhd(probs_masked), half_d, use_float64)
    return torch.sum(half.mean(0) / float(half_d))
