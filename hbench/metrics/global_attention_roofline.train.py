"""ViT's global attention in the traced training steps (%): the least time
of the program's attention launches (``seghiero_torch/ops/attention.py``
``sr_attention`` with as many keys as queries: the hand-written pair's
forward #10, whose kernel is named ``…flash_fwd…``, and backward #10b,
whose dq, dk/dv and sum launches are named ``…flash_bwd…``; SDPA's flash
kernels carry the same words) over their device time,
``core/kernelwork.py``'s roofline over these two counts alone.

The counts are reckoned from the unit's ``batch`` and ``hw`` and from
the ViT constants of the configuration of the cells this metric lists in
``BENCHMARK.json`` (``depth``, ``num_heads``, ``head_dim`` and
``patch_size``): ``N = (H/p)·(W/p) + 1`` tokens (the patch grid and the
CLS token). A unit does not say which configuration ran it, so cells
whose configurations give different constants raise an error here rather
than read one cell's launches at another's widths: count the launches
under ``kernels/`` before such a cell is added. Every block runs one
forward and one backward on ``[B, h, N, d]``. The least work is what any
implementation must do, so that a later fused kernel cannot read over
100 %:

* forward: read q, k and v, write o (bf16); ``4·B·h·N²·d`` FLOPs (``QKᵀ``
  and ``PV``);
* backward: read q, k, v, o and dO, write dq, dk and dv (bf16);
  ``8·B·h·N²·d`` FLOPs (``dV``, ``dP``, ``dQ``, ``dK``; the recompute of S
  is the implementation's);

both at the bf16 dense rate.

The launch counts are predicted, not measured: one forward and one
backward a block, ``depth`` of each a step (24 at ViT-L/16). The
program's counters (``seghiero_torch.ops.attention.launches`` and
``bwd_launches``) are not read, because the harness resets and reads counters only for the files
under ``kernels/``, and every file there adds an entry to each cell's
pinned kernel works (``hbench/tests/test_pins.py``). So a change that
drops or merges attention launches keeps this least time while the device
time falls, and the share then reads too high: move these counts to
``kernels/`` before such a change."""

from functools import partial
from types import SimpleNamespace

from hbench.core import kernelwork, peaks, spec

NAME = "global_attention_roofline.train"
BF16 = 2


def constants(config):
    """``(depth, heads, head_dim, patch)`` of a ViT configuration file."""
    return tuple(int(config[k]) for k in ("depth", "num_heads", "head_dim", "patch_size"))


def listed(bench=None):
    """The ViT constants of every cell this metric lists: one set, or an error."""
    bench = bench or spec.Bench()
    entry = next(m for m in bench.spec["per_layer"] if m["name"] == NAME)
    found = {constants(bench.config(bench.workload(w)["config"])) for w in entry["workloads"]}
    if len(found) != 1:
        raise ValueError(f"{NAME}: its cells' configurations give the ViT constants "
                         f"{sorted(found)}, and a unit does not say which it ran")
    return found.pop()


def blocks(u, vit):
    """``(B, h, N, d)`` of each block of a unit at the ViT constants ``vit``,
    in the order they run."""
    depth, heads, head_dim, patch = vit
    H, W = u["hw"]
    return [(u["batch"], heads, (H // patch) * (W // patch) + 1, head_dim)] * depth


def forward(u, vit):
    return [{"bytes": 4 * B * h * N * d * BF16, "flops": 4 * B * h * N * N * d,
             "flops_per_s": peaks.BF16_FLOPS} for B, h, N, d in blocks(u, vit)]


def backward(u, vit):
    return [{"bytes": 8 * B * h * N * d * BF16, "flops": 8 * B * h * N * N * d,
             "flops_per_s": peaks.BF16_FLOPS} for B, h, N, d in blocks(u, vit)]


def kernels(vit):
    return {
        "global_attention_fwd": SimpleNamespace(NAMES=("flash_fwd",),
                                                launches=partial(forward, vit=vit)),
        "global_attention_bwd": SimpleNamespace(NAMES=("flash_bwd",),
                                                launches=partial(backward, vit=vit)),
    }


def read(run):
    if run.kind != "train" or not run.trace:
        return None
    ks = kernels(listed())
    n = {k: sum(len(m.launches(g)) for g in run.trace["geos"]) for k, m in ks.items()}
    return kernelwork.roofline(dict(run.trace, launches=n), ks)
