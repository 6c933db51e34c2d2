"""MiT's attention in the traced training steps (%): the least time of the
program's attention launches (``seghiero_torch/ops/attention.py``: the
flash or memory-efficient forward and backward) over their device time,
``core/kernelwork.py``'s roofline over these two counts alone.

The counts are reckoned from the unit as it is (``core/geometry.py``).
Every MiT block runs one Mix-FFN depthwise 3x3 at its own grid and at 4x
its width, so each dilation-1 entry ``(B, H, W, C, 1)`` stands for one
attention forward and one backward with ``N = H·W`` queries, ``dim = C/4``
channels (``h = dim/64`` heads of 64 in MiT-B1 to B5), ``sr = 32·H/hw[0]``
and ``M = (H/sr)·(W/sr)`` keys and values. The forward reads q, k and v
and writes o (bf16) and does ``4·B·h·N·M·d`` FLOPs (``QKᵀ`` and ``PV``);
the backward reads q, k, v, o and dO, writes dq, dk and dv, and does
``8·B·h·N·M·d`` (``dV``, ``dP``, ``dQ``, ``dK``; the recompute of S is the
implementation's, not the least work), both at the bf16 dense rate.

The launch counts are predicted, not measured: one forward and one
backward for each such entry of each traced unit. The program's counters
(``seghiero_torch.ops.attention.launches`` and ``bwd_launches``) are not
read, because the harness resets and reads counters only for the files
under ``kernels/``, and every file there adds an entry to each cell's
pinned kernel works (``hbench/tests/test_pins.py``). So a change that
drops or merges attention launches keeps this least time while the device
time falls, and the share then reads too high: move these counts to
``kernels/`` before such a change."""

from types import SimpleNamespace

from hbench.core import kernelwork, peaks


def _shapes(u):
    for B, H, W, C, dilation in u["depthwise"]:
        if dilation == 1:
            sr = max(1, round(32 * H / u["hw"][0]))
            yield B, H * W, (H // sr) * (W // sr), C // 4


def forward(u):
    return [{"bytes": 2 * (2 * B * N * dim + 2 * B * M * dim), "flops": 4 * B * N * M * dim,
             "flops_per_s": peaks.BF16_FLOPS} for B, N, M, dim in _shapes(u)]


def backward(u):
    return [{"bytes": 2 * (4 * B * N * dim + 4 * B * M * dim), "flops": 8 * B * N * M * dim,
             "flops_per_s": peaks.BF16_FLOPS} for B, N, M, dim in _shapes(u)]


KERNELS = {
    "sr_attention_fwd": SimpleNamespace(NAMES=("flash_fwd", "fmha_cutlassF"), launches=forward),
    "sr_attention_bwd": SimpleNamespace(NAMES=("flash_bwd", "fmha_cutlassB"), launches=backward),
}


def read(run):
    if run.kind != "train" or not run.trace:
        return None
    n = {k: sum(len(m.launches(g)) for g in run.trace["geos"]) for k, m in KERNELS.items()}
    return kernelwork.roofline(dict(run.trace, launches=n), KERNELS)
