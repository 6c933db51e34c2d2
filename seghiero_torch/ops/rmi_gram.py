"""The RMI Gram kernels and the half-logdet they feed — the port of
``seghiero_tpu/ops/pallas/rmi_gram.py`` (``_gram18``, ``_residual_gram``,
``_grad_maps``, ``_solve_w``, ``_finish_logdet`` and the ``custom_vjp``
``_half_logdet``, :153-446), for radius 3 in f32, in both precisions.

Per map pair (one-hot ``la``, probabilities ``pr``, both ``[BC, H, W]``)
the 18 views ``z`` are the 3×3 shifted views ``map[r+dy, c+dx]`` of both
maps over the ``nh × nw = (H−2) × (W−2)`` output pixels (not centred).

* ``gram18`` — kernel #6 (``csrc/rmi_gram.cu``): ``G18 = z·zᵀ``, raw sums
  ``[BC, 18, 18]``; the kernel computes each entry as a lag sum
  ``Σ_x map_a(x)·map_b(x + l)`` anchored at one of its two views: inside
  the 2-pixel frame the 171 entries share 51 such sums (51 FMAs a pixel),
  on the frame each entry keeps the general form;
* ``residual_gram`` — kernel #7: ``A = y·yᵀ`` with ``y = z_la − Wᵀ·z_pr``,
  ``[BC, 9, 9]``, in f32 FMAs (81 + 45 a pixel, 4 columns a thread, rows
  staged with 16-byte copies); its bf16 variant #7f runs both products on
  the tensor cores (``mma.sync`` bf16 → f32, 4 per 16 pixels a warp); both
  on 32 × 256 tiles of output pixels;
* ``grad_maps`` — kernel #8: ``u = P·z`` per output pixel, its 9 shifted
  rows overlap-added into ``dpr [BC, H, W]``; the kernel computes it inside
  the 2-pixel frame as a 5×5 correlation of each map with taps folded from
  ``P`` once per map (50 FMAs a pixel), on the frame in this general form.

``precision="fast"`` (``training.rmi_precision: fast``) selects the bf16-view
variants #6f–#8f: the TPU kernel's bf16 ``z`` scratch and single-pass bf16
dots with f32 accumulation, i.e. the maps' values, ``W``, the residual ``y``
and ``P`` rounded to bf16 (nearest even) where the TPU kernel rounds them,
every product and sum in f32 (a product of two bf16 values is exact in
f32, so an f32 product of rounded operands is the bf16 dot's).

Each wrapper launches its kernel for a tensor on the card and runs its
plain PyTorch version (which materializes ``z``) for a tensor on the CPU;
any other device raises. The 1/N scaling, the 9×9 solve and the Cholesky
stay in ``torch.linalg`` (``_solve_w``, ``_finish_logdet``), as the JAX
package leaves them to XLA. ``rmi_logdet_kernel_cmajor(oh, pr)`` returns
the ``[B, C]`` half-logdets through ``_HalfLogdet``, the
``torch.autograd.Function`` whose backward is the algebra of
``_half_logdet_bwd`` and kernel #8: the kernel path never materializes
the ``[B, C, 9, N]`` neighbourhood tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from seghiero_torch.ops import _build

_POS_ALPHA = 1e-3  # rmi_hiera_triplet_loss.py:18 of the reference
# kResTileH, kResTileW: the tiles of output pixels of #7 and #7f
RES_TILE_H, RES_TILE_W = 32, 256
# the shapes the kernels take (csrc/rmi_gram.cu shape_ok): the maps lie
# along gridDim.y, and offsets within a map are 32-bit
MAX_MAPS = 65535
MAX_MAP_FLOATS = 2**31 - 1
# kernel #6's interior tiles and frame anchors per frame block
# (csrc/rmi_gram.cu kGradTileH, kGradTileW, kGramFrame)
TILE_H, TILE_W, GRAM_FRAME = 32, 256, 256

PRECISIONS = ("parity", "fast")

# kernel launches in this process (set to 0 to count a run): the f32
# kernels #6–#8 and their bf16-view variants #6f–#8f
gram18_launches = 0
residual_launches = 0
grad_launches = 0
gram18_fast_launches = 0
residual_fast_launches = 0
grad_fast_launches = 0
COUNTERS = ("gram18_launches", "residual_launches", "grad_launches", "gram18_fast_launches",
            "residual_fast_launches", "grad_fast_launches")


def _check_precision(precision: str) -> bool:
    """True for ``"fast"`` (bf16 views), False for ``"parity"``."""
    if precision not in PRECISIONS:
        raise ValueError(f"rmi precision must be one of {PRECISIONS}, got {precision!r}")
    return precision == "fast"


# ---------------------------------------------------------------------------
# plain versions: the kernels' raw f32 sums in PyTorch
def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest bf16 (ties to even), in ``x``'s dtype: the
    TPU kernel's ``astype(bfloat16)`` of a value it then multiplies."""
    return x.to(torch.bfloat16).to(x.dtype)


def _views(m: torch.Tensor) -> torch.Tensor:
    """``[BC, H, W]`` → the 9 views ``[BC, 9, nh·nw]``, k = 3·dy + dx."""
    BC, H, W = m.shape
    nh, nw = H - 2, W - 2
    return torch.stack([m[:, dy : dy + nh, dx : dx + nw] for dy in range(3) for dx in range(3)],
                       dim=1).reshape(BC, 9, nh * nw)


def gram18_plain(la: torch.Tensor, pr: torch.Tensor, precision: str = "parity") -> torch.Tensor:
    if _check_precision(precision):
        la, pr = bf16_round(la), bf16_round(pr)
    z = torch.cat([_views(la), _views(pr)], dim=1)
    return z @ z.mT


def residual_gram_plain(la: torch.Tensor, pr: torch.Tensor, w: torch.Tensor,
                        precision: str = "parity") -> torch.Tensor:
    fast = _check_precision(precision)
    if fast:
        la, pr, w = bf16_round(la), bf16_round(pr), bf16_round(w)
    y = _views(la) - w.mT @ _views(pr)
    if fast:
        y = bf16_round(y)
    return y @ y.mT


def grad_maps_plain(la: torch.Tensor, pr: torch.Tensor, p: torch.Tensor,
                    precision: str = "parity") -> torch.Tensor:
    BC, H, W = pr.shape
    nh, nw = H - 2, W - 2
    if _check_precision(precision):
        la, pr, p = bf16_round(la), bf16_round(pr), bf16_round(p)
    u = (p @ torch.cat([_views(la), _views(pr)], dim=1)).reshape(BC, 9, nh, nw)
    dpr = torch.zeros((BC, H, W), dtype=u.dtype, device=pr.device)
    for dy in range(3):
        for dx in range(3):
            dpr[:, dy : dy + nh, dx : dx + nw] += u[:, dy * 3 + dx]
    return dpr


# ---------------------------------------------------------------------------
# kernel wrappers
def _check_maps(la: torch.Tensor, pr: torch.Tensor, what: str, *small):
    """(BC, H, W) of two matching contiguous f32 maps on the card; ``small``
    are ``(tensor, shape)`` pairs that must match too."""
    if pr.ndim != 3 or pr.shape[1] < 3 or pr.shape[2] < 3:
        raise ValueError(f"{what}: maps must be [BC, H, W] with H, W >= 3, got {tuple(pr.shape)}")
    BC = pr.shape[0]
    for t, shape in ((la, pr.shape), (pr, pr.shape), *small):
        if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 or t.device != pr.device:
            raise ValueError(f"{what}: expected f32 {tuple(shape)} on {pr.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} needs contiguous operands; refusing to copy")
    if not kernel_shape_ok(BC, *pr.shape[1:]):
        raise ValueError(f"{what}: at most {MAX_MAPS} maps of at most {MAX_MAP_FLOATS} "
                         f"floats, got {tuple(pr.shape)}")
    return pr.shape


def kernel_shape_ok(BC: int, H: int, W: int) -> bool:
    """Whether the kernels take ``BC`` maps of ``H × W`` (H, W >= 3)."""
    return BC <= MAX_MAPS and H * W <= MAX_MAP_FLOATS


def residual_tiles(H: int, W: int) -> int:
    """Partial rows per map of kernels #7 and #7f (one per tile of output
    pixels)."""
    return -(-(W - 2) // RES_TILE_W) * -(-(H - 2) // RES_TILE_H)


def gram18_scratch(H: int, W: int) -> int:
    """Floats of kernel #6's partial sums per map (``tile_grid`` and
    ``gram18_scratch`` of csrc/rmi_gram.cu): 171 per frame block, 51 per
    interior tile of the core (rows and columns 2 … H−3, W−3); below 5 × 5
    there is no core and every pixel is frame."""
    nir, nic = max(H - 4, 0), max(W - 4, 0)
    tiles = -(-nic // TILE_W) * -(-nir // TILE_H)
    frame = 4 * W + 4 * nir if tiles else H * W
    return -(-frame // GRAM_FRAME) * 171 + tiles * 51


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def _count(name: str, fast: bool) -> None:
    """One launch of kernel ``name`` (#6–#8) or of its bf16 variant."""
    key = f"{name}_fast_launches" if fast else f"{name}_launches"
    globals()[key] += 1


def gram18(la: torch.Tensor, pr: torch.Tensor, precision: str = "parity") -> torch.Tensor:
    """Raw ``G18 = z·zᵀ`` ``[BC, 18, 18]`` f32: kernel #6 (#6f for
    ``precision="fast"``) on the card, one launch (its lag sums and the
    finish that adds them into both triangles)."""
    fast = _check_precision(precision)
    if not _build.on_card(pr, "rmi gram18"):
        return gram18_plain(la, pr, precision)
    BC, H, W = _check_maps(la, pr, "rmi gram18")
    scratch = gram18_scratch(H, W)
    partial = torch.empty((BC, scratch), dtype=torch.float32, device=pr.device)
    out = torch.empty((BC, 18, 18), dtype=torch.float32, device=pr.device)
    lib = _build.library()
    err = lib.seghiero_rmi_gram18(la.data_ptr(), pr.data_ptr(), partial.data_ptr(),
                                  out.data_ptr(), BC, H, W, scratch, int(fast), pr.device.index,
                                  _stream(pr))
    _build.check(lib, err, "rmi gram18")
    _count("gram18", fast)
    return out


def residual_gram(la: torch.Tensor, pr: torch.Tensor, w: torch.Tensor,
                  precision: str = "parity") -> torch.Tensor:
    """Raw ``A = y·yᵀ``, ``y = z_la − Wᵀ·z_pr``, ``[BC, 9, 9]`` f32 for the
    regression ``w [BC, 9, 9]``: kernel #7 (#7f) on the card, one launch
    (its partial rows and the finish that adds them into both triangles)."""
    fast = _check_precision(precision)
    if not _build.on_card(pr, "rmi residual_gram"):
        return residual_gram_plain(la, pr, w, precision)
    BC, H, W = _check_maps(la, pr, "rmi residual_gram", (w, (pr.shape[0], 9, 9)))
    nblk = residual_tiles(H, W)
    partial = torch.empty((BC, nblk, 45), dtype=torch.float32, device=pr.device)
    out = torch.empty((BC, 9, 9), dtype=torch.float32, device=pr.device)
    lib = _build.library()
    err = lib.seghiero_rmi_residual(la.data_ptr(), pr.data_ptr(), w.data_ptr(),
                                    partial.data_ptr(), out.data_ptr(), BC, H, W, nblk,
                                    int(fast), pr.device.index, _stream(pr))
    _build.check(lib, err, "rmi residual_gram")
    _count("residual", fast)
    return out


def grad_maps(la: torch.Tensor, pr: torch.Tensor, p: torch.Tensor,
              precision: str = "parity") -> torch.Tensor:
    """``dpr [BC, H, W]`` f32: ``u = P·z`` (``p [BC, 9, 18]``) overlap-added
    through the 9 views: kernel #8 (#8f) on the card, one launch (the
    interior's folded 5×5 correlation and the frame's general form are
    blocks of the same grid)."""
    fast = _check_precision(precision)
    if not _build.on_card(pr, "rmi grad_maps"):
        return grad_maps_plain(la, pr, p, precision)
    BC, H, W = _check_maps(la, pr, "rmi grad_maps", (p, (pr.shape[0], 9, 18)))
    dpr = torch.empty_like(pr)
    lib = _build.library()
    err = lib.seghiero_rmi_grad_maps(la.data_ptr(), pr.data_ptr(), p.data_ptr(),
                                     dpr.data_ptr(), BC, H, W, int(fast), pr.device.index,
                                     _stream(pr))
    _build.check(lib, err, "rmi grad_maps")
    _count("grad", fast)
    return dpr


# ---------------------------------------------------------------------------
# the solve and the logdet on the small Grams (N-normalized, noise-aware
# jitter: the numerics of losses/rmi.py:_rmi_logdet_core)
_EPS_REL = 32 * float(np.finfo(np.float32).eps)


def _jitter(m: torch.Tensor, alpha_n: float, eps_rel: float = _EPS_REL) -> torch.Tensor:
    """The diagonal jitter ``max(α/N, eps_rel · mean diag)``, ``[..., 1, 1]``."""
    mean_diag = torch.diagonal(m, dim1=-2, dim2=-1).mean(-1)
    return torch.maximum(torch.full_like(mean_diag, alpha_n), eps_rel * mean_diag)[..., None, None]


def _regression(pr_cov: torch.Tensor, la_pr: torch.Tensor, n: int,
                eps_rel: float) -> torch.Tensor:
    """W from the N-normalized Grams: the jittered probability covariance
    solved against ``la_prᵀ`` (``solve_ex``: no host sync)."""
    eye = torch.eye(pr_cov.shape[-1], dtype=pr_cov.dtype, device=pr_cov.device)
    m_pr = pr_cov + eye * _jitter(pr_cov, _POS_ALPHA / n, eps_rel)
    return torch.linalg.solve_ex(m_pr, la_pr.mT)[0]


def _half_logdet(appro_var: torch.Tensor, n: int, eps_rel: float) -> torch.Tensor:
    """``0.5·logdet`` f32 of the N-normalized residual Gram, symmetrized and
    jittered (``cholesky_ex``: no host sync; not positive definite gives
    NaN), with the reference's log(diag + 1e-8) guard at the unnormalized
    scale."""
    appro_var = 0.5 * (appro_var + appro_var.mT)
    eye = torch.eye(appro_var.shape[-1], dtype=appro_var.dtype, device=appro_var.device)
    chol = torch.linalg.cholesky_ex(
        appro_var + eye * _jitter(appro_var, _POS_ALPHA / n, eps_rel))[0]
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1) * float(np.sqrt(n))
                             + 1e-8).sum(-1)
    return (0.5 * logdet).to(torch.float32)


def _solve_w(g18_raw: torch.Tensor, n: int) -> torch.Tensor:
    """The regression W ``[BC, 9, 9]`` from the raw 18×18 Gram. Like JAX, a
    bad batch gives non-finite values, not an exception. Contiguous, as
    kernel #7 takes it (the solve returns it column-major)."""
    return _regression(g18_raw[:, 9:, 9:] * (1.0 / n), g18_raw[:, 0:9, 9:] * (1.0 / n), n,
                       _EPS_REL).contiguous()


def _finish_logdet(a_raw: torch.Tensor, n: int) -> torch.Tensor:
    """The half-logdets ``[BC]`` from the raw residual Gram."""
    return _half_logdet(a_raw * (1.0 / n), n, _EPS_REL)


class _HalfLogdet(torch.autograd.Function):
    """The ``custom_vjp`` ``_half_logdet``: forward kernels #6 and #7 around
    the solve; backward the small algebra of ``_half_logdet_bwd`` and one
    pass of kernel #8 (#6f–#8f for ``precision="fast"``; the solve, the
    logdet and the algebra stay f32, as in JAX). The one-hot map gets no
    gradient."""

    @staticmethod
    def forward(ctx, oh, pr, n, precision):
        g18 = gram18(oh, pr, precision)
        w = _solve_w(g18, n)
        a_raw = residual_gram(oh, pr, w, precision)
        ctx.save_for_backward(oh, pr, g18, w, a_raw)
        ctx.n, ctx.precision = n, precision
        return _finish_logdet(a_raw, n)

    @staticmethod
    def backward(ctx, dhalf):
        oh, pr, g18, w, a_raw = ctx.saved_tensors
        p = backward_p(g18, w, a_raw, dhalf, ctx.n)
        return None, grad_maps(oh, pr, p, ctx.precision), None, None


def backward_p(g18: torch.Tensor, w: torch.Tensor, a_raw: torch.Tensor, dhalf: torch.Tensor,
               n: int) -> torch.Tensor:
    """``P [BC, 9, 18]`` of the backward, ``d pr = grad_maps(P)``, from the
    forward's residuals and the half-logdets' cotangent: with ``S = [I | −Wᵀ]``
    and ``M = dA + dAᵀ``, the residual Gram gives ``Q = −W·M·S`` and
    ``dW = −((M·S·G18)[:, 9:])ᵀ``, the solve ``dG18``, and
    ``P = Q + (dG18 + dG18ᵀ)[9:, :]``. The two small VJPs are autograd's."""
    with torch.enable_grad():  # the logdet's cotangent → dA_raw
        a = a_raw.detach().requires_grad_()
        (dA,) = torch.autograd.grad(_finish_logdet(a, n), a, dhalf)
    M = dA + dA.mT  # [BC, 9, 9]
    eye = torch.eye(9, dtype=torch.float32, device=w.device).expand_as(w)
    S = torch.cat([eye, -w.mT], dim=-1)  # [BC, 9, 18]
    MS = M @ S
    Q = -(w @ MS)
    dw = -(MS @ g18)[:, :, 9:].mT
    with torch.enable_grad():  # the solve's cotangent → dG18
        g = g18.detach().requires_grad_()
        (dG18,) = torch.autograd.grad(_solve_w(g, n), g, dw)
    return (Q + (dG18 + dG18.mT)[:, 9:, :]).contiguous()


def rmi_gram_kernel_available(BC: int, H: int, W: int, radius: int, use_float64: bool,
                              device: torch.device) -> bool:
    """The kernels' preconditions (``rmi_gram_pallas_available``): radius 3,
    f32, ``BC`` maps of at least 3×3 on the card, and the launch's limits
    (``kernel_shape_ok``), which the TPU kernel does not have."""
    return (radius == 3 and not use_float64 and H >= 3 and W >= 3 and device.type == "cuda"
            and kernel_shape_ok(BC, H, W))


def rmi_logdet_kernel_cmajor(oh_map: torch.Tensor, pr_map: torch.Tensor,
                             precision: str = "parity") -> torch.Tensor:
    """``[B, C]`` half-logdets of ``_rmi_logdet_core`` for radius 3 in f32,
    from the one-hot targets (no gradient) and the masked probabilities,
    both ``[B, C, H, W]``, through kernels #6–#8 (``precision="fast"``:
    #6f–#8f) on the card, their plain versions on the CPU. On the card both
    maps must be contiguous f32."""
    _check_precision(precision)
    B, C, H, W = pr_map.shape
    if _build.on_card(pr_map, "rmi_logdet_kernel_cmajor") and not (
            pr_map.is_contiguous() and oh_map.is_contiguous()):
        raise ValueError("rmi_logdet_kernel_cmajor needs contiguous maps; refusing to copy")
    oh = oh_map.detach().to(torch.float32).reshape(B * C, H, W)
    pr = pr_map.to(torch.float32).reshape(B * C, H, W)
    return _HalfLogdet.apply(oh, pr, (H - 2) * (W - 2), precision).reshape(B, C)
