"""Swin's window attention in the traced training steps (%): the least
time of the program's window-attention launches
(``seghiero_torch/ops/attention.py`` ``window_attention``: SDPA's
memory-efficient forward ``fmha_cutlassF`` and backward ``fmha_cutlassB``)
over their device time, ``core/kernelwork.py``'s roofline over these two
counts alone.

The counts are reckoned from the unit's ``batch`` and ``hw`` at Swin-L's
widths and window, the constants below (embed dim 192, depths 2/2/18/2,
heads 6/12/24/48, head dimension 32, window 12): the 4×4 patch embedding
leaves ``ceil(H/4)``, each merging halves a side (rounding up), and each
stage's map is padded to window multiples, ``nW`` windows of ``N = 144``
tokens an image. Every block runs one forward and one backward on
``[B·nW, h, N, d]``; the odd blocks of a stage are shifted and add the
region mask. The least work is what any implementation must do, so that
a later fused kernel cannot read over 100 %:

* forward: read q, k and v, write o (bf16), read the table (bf16) and, in
  a shifted block, the ``nW·N²`` mask once; ``4·B·nW·h·N²·d`` FLOPs
  (``QKᵀ`` and ``PV``);
* backward: read q, k, v, o and dO, write dq, dk and dv (bf16) and the
  table's gradient; ``8·B·nW·h·N²·d`` FLOPs (``dV``, ``dP``, ``dQ``,
  ``dK``; the recompute of S is the implementation's);

both at the bf16 dense rate. The ``[B·nW, h, N, N]`` bias that SDPA's
kernels read materialized, and the bias gradient they write, are the
implementation's and not counted.

The launch counts are predicted, not measured: one forward and one
backward a block, 24 of each a step. The program's counters
(``seghiero_torch.ops.attention.window_launches`` and
``window_bwd_launches``) are not read, because the harness resets and
reads counters only for the files under ``kernels/``, and every file
there adds an entry to each cell's pinned kernel works
(``hbench/tests/test_pins.py``). So a change that drops or merges window
attention launches keeps this least time while the device time falls,
and the share then reads too high: move these counts to ``kernels/``
before such a change."""

from types import SimpleNamespace

from hbench.core import kernelwork, peaks

EMBED_DIM = 192
DEPTHS = (2, 2, 18, 2)
HEADS = (6, 12, 24, 48)
WINDOW = 12
PATCH = 4
BF16 = 2


def blocks(u):
    """``(B·nW, h, N, d, shifted)`` of each Swin-L block of a unit, in the
    order they run."""
    H, W = (-(-n // PATCH) for n in u["hw"])
    out = []
    for s, (depth, h) in enumerate(zip(DEPTHS, HEADS)):
        if s:
            H, W = -(-H // 2), -(-W // 2)
        nW = -(-H // WINDOW) * -(-W // WINDOW)
        d = (EMBED_DIM << s) // h
        out += [(u["batch"] * nW, h, WINDOW * WINDOW, d, j % 2 == 1) for j in range(depth)]
    return out


def _table(h):
    return (2 * WINDOW - 1) ** 2 * h * BF16


def forward(u):
    return [{"bytes": 4 * Bw * h * N * d * BF16 + _table(h) + (Bw // u["batch"] * N * N * BF16
                                                              if shifted else 0),
             "flops": 4 * Bw * h * N * N * d, "flops_per_s": peaks.BF16_FLOPS}
            for Bw, h, N, d, shifted in blocks(u)]


def backward(u):
    return [{"bytes": 8 * Bw * h * N * d * BF16 + _table(h),
             "flops": 8 * Bw * h * N * N * d, "flops_per_s": peaks.BF16_FLOPS}
            for Bw, h, N, d, shifted in blocks(u)]


KERNELS = {
    "window_attention_fwd": SimpleNamespace(NAMES=("fmha_cutlassF",), launches=forward),
    "window_attention_bwd": SimpleNamespace(NAMES=("fmha_cutlassB",), launches=backward),
}


def read(run):
    if run.kind != "train" or not run.trace:
        return None
    n = {k: sum(len(m.launches(g)) for g in run.trace["geos"]) for k, m in KERNELS.items()}
    return kernelwork.roofline(dict(run.trace, launches=n), KERNELS)
