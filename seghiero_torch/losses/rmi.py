"""The RMI lower bound in C-major layout (the port of
``seghiero_tpu/losses/rmi.py:54-135`` and of ``rmi_lower_bound_cmajor``,
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
card) and the op elsewhere.
"""

from __future__ import annotations

import numpy as np
import torch

from seghiero_torch.ops.rmi_gram import (
    _EPS_REL,
    _POS_ALPHA,
    _jitter,
    rmi_gram_kernel_available,
    rmi_logdet_kernel_cmajor,
)

_CLIP_MIN = 1e-6  # rmi_hiera_triplet_loss.py:16 of the reference
__all__ = ["_CLIP_MIN", "_POS_ALPHA", "_rmi_logdet_core", "rmi_lower_bound_cmajor"]

# the JAX package streams the Grams over row chunks above this size of the
# neighbourhood tensor (losses/fast.py:393-399)
STREAMING_BYTES = 1536 * 2**20


def _not_yet_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to seghiero_torch (ROADMAP queue 1)")


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
    alpha_n = _POS_ALPHA / n
    eps_rel = 0.0 if use_float64 else _EPS_REL
    eye = torch.eye(half_d, dtype=dt, device=pr.device)
    pr_cov = torch.einsum("bcin,bcjn->bcij", pr, pr)
    la_pr = torch.einsum("bcin,bcjn->bcij", la, pr)
    w = torch.linalg.solve_ex(pr_cov + eye * _jitter(pr_cov, alpha_n, eps_rel), la_pr.mT)[0]
    r = la - torch.einsum("bcji,bcjn->bcin", w, pr)  # residual vectors
    appro_var = torch.einsum("bcin,bcjn->bcij", r, r)  # a Gram matrix: PSD
    appro_var = 0.5 * (appro_var + appro_var.mT)
    chol = torch.linalg.cholesky_ex(appro_var + eye * _jitter(appro_var, alpha_n, eps_rel))[0]
    # the reference's log(diag + 1e-8) guard at the unnormalized scale
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1) * float(np.sqrt(n))
                             + 1e-8).sum(-1)
    return (0.5 * logdet).to(torch.float32)


def rmi_lower_bound_cmajor(oh_all: torch.Tensor, probs_masked: torch.Tensor, *,
                           radius: int = 3, use_float64: bool = False,
                           streaming: str = "auto", backend: str = "auto",
                           precision: str = "parity") -> torch.Tensor:
    """RMI summed over classes (a scalar) from the one-hot targets and the
    masked probabilities, both ``[B, C, H, W]``."""
    if precision != "parity":
        raise _not_yet_ported(f"training.rmi_precision: {precision} (bf16 views in the kernels)")
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
    if backend == "pallas" or (backend == "auto" and rmi_gram_kernel_available(
            H, W, radius, use_float64, probs_masked.device)):
        half = rmi_logdet_kernel_cmajor(oh_all, probs_masked)
        return torch.sum(half.mean(0) / float(half_d))

    if streaming == "on" or (streaming == "auto" and B * C * half_d * nh * nw * 4 > STREAMING_BYTES):
        raise _not_yet_ported("the streaming RMI path (training.rmi_streaming)")

    def nbhd(x):
        views = [x[:, :, y : y + nh, xx : xx + nw] for y in range(radius) for xx in range(radius)]
        return torch.stack(views, dim=2).reshape(B, C, half_d, nh * nw)

    half = _rmi_logdet_core(nbhd(oh_all).detach(), nbhd(probs_masked), half_d, use_float64)
    return torch.sum(half.mean(0) / float(half_d))
