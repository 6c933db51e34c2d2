#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``seghiero_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit (an H100: the kernels are built for sm_90a). Phases, each
printed as one line, any failure exits non-zero:

1. device  — the card's name, the device count, and what ``nvidia-smi``
   reports as its name, power limit and maximum SM clock;
2. build   — ``nvcc`` builds every kernel from ``seghiero_torch/csrc``
   (seconds, and ``-Xptxas -v``'s registers and spills per kernel);
3. kernels — each kernel against its plain PyTorch version at the shapes
   its path gives it (TF32 off; the tolerance stated beside each check;
   the Gram and fused loss kernels also run twice for the same bits),
   then timed with CUDA events against the plain version, the PyTorch
   library call computing the same function (for the fused loss and the
   RMI Gram kernels, which have none, the port's library-op path of the
   same loss term), and the least time the card could take; the
   depthwise kernels also at config 4's shapes (193², odd) and the
   forward at config 5's (``[4, 256, 256, ·]``); the dilated depthwise
   forward (#9) at the served ASPP input ``[4, 128, 128, 2048]`` bf16 at
   dilations 12 / 24 / 36, beside ``F.conv2d(groups=C, dilation=d)``;
   the decode in f32 and bf16, at the serving shape and config 5's
   (``[4, 15, 256, 256]``, 3 levels), eagerly (as a served batch
   launches it) and by CUDA-graph replay (the kernel alone: it is
   shorter than a launch's host cost); MiT's attention pair (#10 / #10b)
   at MiT-B5's four stage shapes, each half's device time (profiler)
   beside SDPA's flash kernels' (``library_ms``) and the plain path's; the
   fused loss kernels also at
   the 150-class config's (``[8, 165, 128, 128]``); the RMI Gram kernels
   at config 3's shapes (f32) and their bf16-view variants at config 4's
   (beside the f32 kernels' times there), #8 / #8f also in turns with
   the same function as two cuDNN calls, then the RMI term at config 4's
   shapes on four routes (fast kernels, parity kernels, materialized op,
   streaming), value, gradient, time and memory;
4. serve   — ``configs/example-serving-hopper.yaml`` at full width with
   the benchmark's seeded weights (``hbench/core/predictlib.py``): the
   port's ``ServingModel`` + ``make_server`` answer two bursts of
   concurrent 512×512 requests on a local port; each response must equal
   the predictor called directly on the same batch, the library-op
   predictor (both backends ``xla``) must agree on ≥99.5% of pixels per
   level, and each kernel's launch counter must show the serving run
   went through it.

The training and inference paths, and how many times a step or a
forward launches each kernel, are the card tests'
(``tests/test_torch_port_cuda.py``) and the benchmark's (``hbench/``).
Then one JSON line ``{"kernels": [...]}`` (each kernel's times and
bound), the ``nvidia-smi`` name/power line, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import io
import json
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # bf16 tensor cores, dense, H100 SXM data sheet
H100_SMS = 132
# special-function unit (MUFU) results per clock per SM on Hopper: ex2,
# lg2, rcp; each expf, logf, log1pf and f32 division counted as one
MUFU_PER_CLOCK_PER_SM = 16
AGREE_MIN = 0.995  # kernel path vs library-op path, pixels per level (bf16)
SEED = 0
N_REQUESTS = 16  # per burst
N_BURSTS = 2


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events over ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_ms_graph(fn, iters: int = 30, replays: int = 5) -> float:
    """Mean device time of one call, from CUDA events around replays of a
    CUDA graph of ``iters`` calls: for kernels shorter than the host's cost
    of launching them, which ``time_ms`` would measure instead."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture needs
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(iters):
            fn()
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / (replays * iters)


def bound(nbytes: int, flops: int, mufu: int = 0, sm_mhz: float = 0.0,
          flops_per_s: float = H100_F32_FLOPS):
    """(least ms, "bytes" | "operations"): bytes over HBM bandwidth, flops
    over ``flops_per_s`` (the non-tensor f32 rate unless the operands are
    bf16), and MUFU operations over 132 SMs × 16 per clock at ``sm_mhz``,
    whichever is longest."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    if mufu:
        t_ops = max(t_ops, mufu / (H100_SMS * MUFU_PER_CLOCK_PER_SM * sm_mhz * 1e6) * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
def phase_device():
    import torch

    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()[0])
    say("device", name=name, count=count, nvidia_smi=smi, max_sm_clock_mhz=sm_mhz,
        torch=torch.__version__, cuda=torch.version.cuda)
    return name, count, smi, sm_mhz


def phase_build():
    from seghiero_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info
    ptxas = [
        line.strip() for line in str(info.get("log", "")).splitlines()
        if "registers" in line or "spill" in line or "Compiling entry" in line
    ]
    say("build", seconds=round(time.perf_counter() - t0, 2), cached=info.get("cached"),
        library=Path(str(info.get("path"))).name)
    for line in ptxas:
        print(f"[build] ptxas {line}", flush=True)


def _sum_entries(entries):
    """One kernel-line entry from per-shape entries: times and bounds add
    up, the error is the largest."""
    out = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": 0.0, "shapes": []}
    for e in entries:
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            out[key] += e[key]
        out["max_abs_err"] = max(out["max_abs_err"], e["max_abs_err"])
        out["shapes"].append(e["shape"])
        out["bound_by"] = e["bound_by"]
    return out


# the head's two sep-bottleneck depthwise convolutions (bf16, NHWC): one
# serving batch or config-2 step, and a config-4 step (193²: odd)
DW_SHAPES = {"config 2": ((8, 128, 128, 560), (8, 128, 128, 512)),
             "config 4": ((2, 193, 193, 560), (2, 193, 193, 512)),
             "config 5": ((4, 256, 256, 560), (4, 256, 256, 512))}
DW_KERNELS = ("depthwise3x3", "depthwise3x3_dgrad", "depthwise3x3_wgrad")


def depthwise_checks(gen, shapes, timed=DW_KERNELS):
    """The three depthwise kernels at ``shapes``: the forward (#1) and the
    input gradient (#1b, the forward kernel with reversed taps) bit-exact
    against their plain versions (the same f32 order, no FMA); the weight
    gradient (#2) within 1e-5 · Σ|x·g| per entry (f32 sums in another order
    than torch.sum's) and the same bits twice. Each is timed beside its
    plain version and, in turns (kernel, library, library, kernel), the
    PyTorch library call computing it; returns the entry of each kernel in
    ``timed`` summed over the shapes, with its time over the library's and
    its share of the bound."""
    import torch
    import torch.nn.functional as F

    from seghiero_torch.ops.depthwise import (
        depthwise3x3,
        depthwise3x3_dgrad,
        depthwise3x3_plain,
        depthwise3x3_wgrad,
        depthwise3x3_wgrad_plain,
    )

    dev = torch.device("cuda")
    entries = {name: [] for name in timed}
    for shape in shapes:
        C = shape[-1]
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        g = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        k9 = (torch.randn((9, C), generator=gen, device=dev) * 0.3).to(torch.bfloat16)
        x_cl, g_cl = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)  # channels_last views
        w = k9.t().reshape(C, 1, 3, 3).contiguous()
        y, dx, dk = depthwise3x3(x, k9), depthwise3x3_dgrad(g, k9), depthwise3x3_wgrad(x, g)
        mag = depthwise3x3_wgrad_plain(x.float().abs(), g.float().abs())
        diff = (dk - depthwise3x3_wgrad_plain(x, g)).abs()
        torch.cuda.synchronize()
        for name, got, want in (("depthwise3x3", y, depthwise3x3_plain(x, k9)),
                                ("depthwise3x3_dgrad", dx, depthwise3x3_plain(g, k9.flip(0)))):
            if not torch.equal(got, want):
                raise AssertionError(f"{name} {shape}: max |kernel − plain| = "
                                     f"{(got.float() - want.float()).abs().max().item()}")
        if not bool((diff <= 1e-5 * mag).all()):
            raise AssertionError(f"depthwise3x3_wgrad {shape}: max |Δ|/Σ|x·g| = "
                                 f"{(diff / mag).max().item()} > 1e-5")
        if not torch.equal(dk, depthwise3x3_wgrad(x, g)):
            raise AssertionError("depthwise3x3_wgrad: two runs differ")
        for name, fn, plain, lib, lib_as_kernel, err, nbytes, extra in (
            ("depthwise3x3", lambda: depthwise3x3(x, k9), lambda: depthwise3x3_plain(x, k9),
             lambda: F.conv2d(x_cl, w, padding=1, groups=C),
             lambda r: (r.permute(0, 2, 3, 1).float() - y.float()), 0.0,
             x.nbytes + k9.nbytes + y.nbytes, {}),
            ("depthwise3x3_dgrad", lambda: depthwise3x3_dgrad(g, k9),
             lambda: depthwise3x3_plain(g, k9.flip(0)),
             lambda: torch.nn.grad.conv2d_input(x_cl.shape, w, g_cl, padding=1, groups=C),
             lambda r: (r.permute(0, 2, 3, 1).float() - dx.float()), 0.0,
             g.nbytes + k9.nbytes + dx.nbytes, {}),
            ("depthwise3x3_wgrad", lambda: depthwise3x3_wgrad(x, g),
             lambda: depthwise3x3_wgrad_plain(x, g),
             lambda: torch.nn.grad.conv2d_weight(x_cl, (C, 1, 3, 3), g_cl, padding=1, groups=C),
             lambda r: (r.float().reshape(C, 9).t() - dk), diff.max().item(),
             x.nbytes + g.nbytes + dk.nbytes,
             {"max_rel_err_of_sum_abs": (diff / mag).max().item()}),
        ):
            if name not in timed:
                continue
            lib_err = lib_as_kernel(lib()).abs().max().item()
            # in turns: kernel, library, library, kernel
            turns = [time_ms(f) for f in (fn, lib, lib, fn)]
            t = {"ms": (turns[0] + turns[3]) / 2, "plain_ms": time_ms(plain, iters=5),
                 "library_ms": (turns[1] + turns[2]) / 2}
            b_ms, b_by = bound(nbytes, 18 * x.numel())
            e = dict(t, shape=list(shape), max_abs_err=err, bound_ms=b_ms, bound_by=b_by)
            say("kernels", kernel=name, dtype="bfloat16", bytes=nbytes,
                library_max_abs_diff=lib_err, share_of_bound=b_ms / t["ms"],
                kernel_over_library=t["ms"] / t["library_ms"], turns_ms=turns, **extra, **e)
            entries[name].append(e)
        del x, g, x_cl, g_cl, y, dx, dk, mag, diff
    summed = {name: _sum_entries(e) for name, e in entries.items()}
    for name, e in summed.items():  # both launches of a batch or step
        e["kernel_over_library"] = e["ms"] / e["library_ms"]
        e["share_of_bound"] = e["bound_ms"] / e["ms"]
        say("kernels", kernel=name, summed_over=e["shapes"], ms=e["ms"],
            library_ms=e["library_ms"], kernel_over_library=e["kernel_over_library"],
            bound_ms=e["bound_ms"], share_of_bound=e["share_of_bound"])
    return summed


# the ASPP's three dilated depthwise convolutions on the backbone's stride-8
# map of a served 1024² batch (bf16, NHWC)
DW_DILATED_SHAPE = (4, 128, 128, 2048)
DW_DILATIONS = (12, 24, 36)


def dilated_checks(gen, shape=DW_DILATED_SHAPE, dilations=DW_DILATIONS):
    """The dilated depthwise forward (#9) at ``shape`` for each dilation:
    bit-exact against its plain version (the same f32 order, no FMA), timed
    beside the plain version and, in turns (kernel, library, library,
    kernel), ``F.conv2d(groups=C, dilation=d)`` on the channels_last view
    (cuDNN as the port calls it), with its bound; returns the entry summed
    over the dilations, with each dilation's under ``"by_dilation"``."""
    import torch
    import torch.nn.functional as F

    from seghiero_torch.ops.depthwise import (
        depthwise3x3_dilated_forward,
        depthwise3x3_dilated_plain,
    )

    C = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    k9 = (torch.randn((9, C), generator=gen, device="cuda") * 0.3).to(torch.bfloat16)
    x_cl = x.permute(0, 3, 1, 2)  # the channels_last view the model holds
    w = k9.t().reshape(C, 1, 3, 3).contiguous()
    entries = []
    for d in dilations:
        y = depthwise3x3_dilated_forward(x, k9, d)
        want = depthwise3x3_dilated_plain(x, k9, d)
        torch.cuda.synchronize()
        if not torch.equal(y, want):
            raise AssertionError(f"depthwise3x3_dilated {shape} d={d}: max |kernel − plain| = "
                                 f"{(y.float() - want.float()).abs().max().item()}")
        del want
        lib = lambda: F.conv2d(x_cl, w, padding=d, dilation=d, groups=C)  # noqa: E731
        lib_err = (lib().permute(0, 2, 3, 1).float() - y.float()).abs().max().item()
        fn = lambda: depthwise3x3_dilated_forward(x, k9, d)  # noqa: E731
        turns = [time_ms(f) for f in (fn, lib, lib, fn)]
        t = {"ms": (turns[0] + turns[3]) / 2, "library_ms": (turns[1] + turns[2]) / 2,
             "plain_ms": time_ms(lambda: depthwise3x3_dilated_plain(x, k9, d), iters=5)}
        nbytes = x.nbytes + k9.nbytes + y.nbytes
        b_ms, b_by = bound(nbytes, 18 * x.numel())
        e = dict(t, shape=list(shape), dilation=d, max_abs_err=0.0, bound_ms=b_ms,
                 bound_by=b_by)
        say("kernels", kernel="depthwise3x3_dilated", dtype="bfloat16", bytes=nbytes,
            library_max_abs_diff=lib_err, share_of_bound=b_ms / t["ms"],
            kernel_over_library=t["ms"] / t["library_ms"], turns_ms=turns, **e)
        entries.append(e)
    out = _sum_entries(entries)
    out["kernel_over_library"] = out["ms"] / out["library_ms"]
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    out["by_dilation"] = {e["dilation"]: {k: e[k] for k in ("ms", "library_ms", "bound_ms")}
                          for e in entries}
    say("kernels", kernel="depthwise3x3_dilated", summed_over=list(dilations), ms=out["ms"],
        library_ms=out["library_ms"], kernel_over_library=out["kernel_over_library"],
        bound_ms=out["bound_ms"], share_of_bound=out["share_of_bound"])
    return out


def phase_kernels(seed: int):
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    results = {}

    # the depthwise kernels at config 2's (and serving's) shapes, and at
    # config 4's and (the forward) config 5's, which the kernels line
    # carries beside them
    results.update(depthwise_checks(gen, DW_SHAPES["config 2"]))
    results["config4"] = depthwise_checks(gen, DW_SHAPES["config 4"])
    results["config5"] = depthwise_checks(gen, DW_SHAPES["config 5"], timed=("depthwise3x3",))
    results["depthwise3x3_dilated"] = dilated_checks(gen)

    # fused 4× upsample + per-level argmax at the serving decode shape and at
    # config 5's, in f32 and in bf16 (the serving model's logits)
    results["upsample_argmax"] = decode_checks(gen)
    results["config5"]["upsample_argmax"] = decode_checks(gen, *DECODE5)

    # the attention pair at MiT-B5's four stages and at ViT-L/16's blocks
    results.update(attention_checks(gen))
    return results


# the attention pair's shapes of a 1024² image at batch 1 (B, h, N, M, d,
# layout): MiT-B5's four stages, q and kv from two projections ("q,kv"), and
# ViT-L/16's global attention over its 4 097 tokens, q, k and v from one
# fused projection ("qkv"; 65 key tiles, the last ragged)
ATTENTION_SHAPES = ((1, 1, 65536, 1024, 64, "q,kv"), (1, 2, 16384, 1024, 64, "q,kv"),
                    (1, 5, 4096, 1024, 64, "q,kv"), (1, 8, 1024, 1024, 64, "q,kv"),
                    (1, 16, 4097, 4097, 64, "qkv"))


def _device_ms(fn, names, iters: int = 10):
    """Mean device time of one call of ``fn`` in the kernels whose names
    hold any of ``names`` (profiler, after two warm-up calls), each name
    apart."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {n: 0.0 for n in names}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            for n in names:
                if n in e.name:
                    out[n] += e.device_time / 1e3 / iters
    return out


def attention_checks(gen, shapes=ATTENTION_SHAPES):
    """The attention pair (#10 forward, #10b backward) in bf16 at ``shapes``,
    on the strided views of the models' projections (MiT's q and kv, ViT's
    fused qkv): output and q, k, v gradients within 2e-2 of the
    largest against the plain path in f32; each half's device time
    (profiler: the kernels named ``flash_fwd`` / ``flash_bwd``, a forward
    and backward a call) beside SDPA's flash kernels' and the plain path's
    (CUDA events, forward and backward). Returns both entries summed over
    the shapes, each shape's under ``by_shape``."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from seghiero_torch.ops import attention

    dev = torch.device("cuda")
    entries = {"sr_attention_fwd": [], "sr_attention_bwd": []}
    for B, h, N, M, d, layout in shapes:
        if layout == "qkv":  # models/vit.py's views of one [B, N, 3, h, d] projection
            qkv = torch.randn((B, N, 3, h, d), generator=gen, device=dev).to(torch.bfloat16)
            q, k, v = qkv.requires_grad_().permute(2, 0, 3, 1, 4)
        else:  # MiT's views of its q [B, N, h, d] and kv [B, M, 2, h, d] projections
            q = torch.randn((B, N, h, d), generator=gen, device=dev).to(torch.bfloat16)
            kv = torch.randn((B, M, 2, h, d), generator=gen, device=dev).to(torch.bfloat16)
            q = q.requires_grad_().transpose(1, 2)
            k, v = kv.requires_grad_().permute(2, 0, 3, 1, 4)
        g = torch.randn((B, h, N, d), generator=gen, device=dev).to(torch.bfloat16)
        out = attention.sr_attention(q, k, v)
        grads = torch.autograd.grad(out, (q, k, v), g)
        q2, k2, v2 = (t.detach().float().requires_grad_() for t in (q, k, v))
        ref = attention.sr_attention_plain(q2, k2, v2)
        ref_grads = torch.autograd.grad(ref, (q2, k2, v2), g.float())
        errs = [((a.float() - b).abs().max() / b.abs().max()).item()
                for a, b in zip((out, *grads), (ref, *ref_grads))]
        if max(errs) > 2e-2:
            raise AssertionError(f"sr_attention {(B, h, N, M, d, layout)}: |kernel − plain| / max "
                                 f"(o, dq, dk, dv) = {errs} > 2e-2")
        del out, grads, ref, ref_grads

        def kernel():
            torch.autograd.grad(attention.sr_attention(q, k, v), (q, k, v), g)

        def library():
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
                out = F.scaled_dot_product_attention(q, k, v)
            torch.autograd.grad(out, (q, k, v), g)

        def plain():
            torch.autograd.grad(attention.sr_attention_plain(q2, k2, v2), (q2, k2, v2),
                                g.float())

        names = ("flash_fwd", "flash_bwd")
        # in turns: kernel, library, library, kernel
        turns = [_device_ms(f, names) for f in (kernel, library, library, kernel)]
        with torch.no_grad():
            plain_fwd = time_ms(lambda: attention.sr_attention_plain(q2, k2, v2), iters=3)
        plain_ms = {"flash_fwd": plain_fwd, "flash_bwd": time_ms(plain, iters=3) - plain_fwd}
        work = B * h * N * M * d
        for name, key, nbytes, flops in (
            ("sr_attention_fwd", "flash_fwd", 2 * (2 * B * h * N * d + 2 * B * h * M * d),
             4 * work),
            ("sr_attention_bwd", "flash_bwd", 2 * (4 * B * h * N * d + 4 * B * h * M * d),
             8 * work),
        ):
            ms = [tr[key] for tr in turns]
            t = {"ms": (ms[0] + ms[3]) / 2, "library_ms": (ms[1] + ms[2]) / 2,
                 "plain_ms": plain_ms[key]}
            b_ms, b_by = bound(nbytes, flops, flops_per_s=H100_BF16_FLOPS)
            e = dict(t, shape=[B, h, N, M, d], layout=layout, max_abs_err=max(errs),
                     bound_ms=b_ms, bound_by=b_by)
            say("kernels", kernel=name, dtype="bfloat16", rel_errs_o_dq_dk_dv=errs,
                splits=attention.backward_splits(B, h, N, M), share_of_bound=b_ms / t["ms"],
                kernel_over_library=t["ms"] / t["library_ms"], turns_ms=ms, **e)
            entries[name].append(e)
        del q, k, v, g, q2, k2, v2
    summed = {}
    for name, es in entries.items():
        e = summed[name] = _sum_entries(es)
        e["by_shape"] = [{x: s[x] for x in ("shape", "ms", "library_ms", "plain_ms", "bound_ms")}
                         for s in es]
        e["share_of_bound"] = e["bound_ms"] / e["ms"]
        say("kernels", kernel=name, summed_over=e["shapes"], ms=e["ms"],
            library_ms=e["library_ms"], bound_ms=e["bound_ms"], share_of_bound=e["share_of_bound"])
    return summed


# config 5's decode (``example-serving-3level-r101-hopper.yaml``: batch 4 of
# 1024², 15 channels in 3 levels)
DECODE5 = ((4, 15, 256, 256), ((0, 9), (9, 13), (13, 15)))


def decode_checks(gen, shape=(8, 13, 128, 128), slices=((0, 9), (9, 13))):
    """The decode kernel (#3) at ``shape`` (default the serving shape, 2
    levels; config 5's is ``[4, 15, 256, 256]``, 3 levels), in f32 and
    bf16: its masks equal the plain version's (stated
    tolerance: exact); timed beside the plain version and the library
    decode (``F.interpolate`` + ``argmax``), with its bound. ``ms`` and
    ``library_ms`` are eager event timings, what a served batch sees (it
    launches the kernel eagerly, host cost included); ``graph_ms`` and
    ``library_graph_ms`` replay a CUDA graph of the same calls, the
    kernel's own time (it is shorter than the host's cost of a launch).
    Returns the f32 entry with the bf16 one under ``"bfloat16"``."""
    import torch
    import torch.nn.functional as F

    from seghiero_torch.ops.upsample_argmax import upsample_argmax, upsample_argmax_plain

    B, C, h, w = shape
    slices = [tuple(sl) for sl in slices]
    lo32 = torch.randn((B, C, h, w), generator=gen, device="cuda")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        lo = lo32.to(dtype)
        got, want = upsample_argmax(lo, slices), upsample_argmax_plain(lo, slices)
        torch.cuda.synchronize()
        mism = sum(int((g != r).sum().item()) for g, r in zip(got, want))
        err = max(int((g - r).abs().max().item()) for g, r in zip(got, want))
        if mism:  # stated tolerance: exact
            raise AssertionError(f"upsample_argmax ({dtype}): {mism} pixels differ from the "
                                 "plain version")

        def library_decode():
            up = F.interpolate(lo, size=(4 * h, 4 * w), mode="bilinear", align_corners=False)
            return [up[:, a:b].argmax(dim=1).to(torch.int32) for a, b in slices]

        lib_agree = min(float((g == r).float().mean().item())
                        for g, r in zip(got, library_decode()))
        t = {
            "ms": time_ms(lambda: upsample_argmax(lo, slices)),
            "graph_ms": time_ms_graph(lambda: upsample_argmax(lo, slices)),
            "plain_ms": time_ms(lambda: upsample_argmax_plain(lo, slices), iters=5),
            "library_ms": time_ms(library_decode),
            "library_graph_ms": time_ms_graph(library_decode),
        }
        nbytes = lo.nbytes + sum(o.nbytes for o in got)
        # per output pixel and channel: 6 multiplies, 3 adds, 1 compare
        b_ms, b_by = bound(nbytes, 10 * B * 16 * h * w * C)
        name = str(dtype).replace("torch.", "")
        say("kernels", kernel="upsample_argmax", shape=[B, C, h, w], dtype=name,
            levels=slices, max_abs_err=err, library_pixel_agreement=lib_agree, bytes=nbytes,
            bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / t["ms"],
            graph_share_of_bound=b_ms / t["graph_ms"],
            graph_timing="CUDA graph of 30 calls, replayed 5 times", **t)
        out[name] = dict(t, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                         shapes=[[B, C, h, w]])
    return dict(out["float32"], bfloat16=out["bfloat16"])


def fused_loss_checks(gen, config: str, sm_mhz: float):
    """The fused upsample + hierarchy-BCE + CE forward (#4) and backward
    (#5) at one config's shapes: random low-res logits ``[8, C, 128, 128]``
    f32 with the training split's first 8 label maps (512², ~2 % ignore),
    each kernel against its plain version (and run twice for the same
    bits), then timed against the plain version, the port's unfused path
    (``F.interpolate`` + the PyTorch loss ops), forward and forward +
    backward, and the bound."""
    import torch

    from seghiero_torch.config import load_config
    from seghiero_torch.data.dataset import build_dataset
    from seghiero_torch.losses.fast import _ce_cmajor, hiera_bce_two_level_cmajor
    from seghiero_torch.losses.hiera import prepare_targets_two_level
    from seghiero_torch.ops import hiera2_fused as fused
    from seghiero_torch.ops.resize import resize_bilinear

    dev = torch.device("cuda")
    cfg = load_config(str(ROOT / "configs" / config))
    hier = cfg.hierarchy
    ds = build_dataset(cfg, "train", seed=cfg.training.seed)
    labels = torch.from_numpy(np.stack([ds[i]["fine"] for i in range(8)])).to(dev)
    tf, tc = prepare_targets_two_level(labels, hier)
    tf, tc = tf.to(torch.int32).contiguous(), tc.to(torch.int32).contiguous()
    B, C, h, w = 8, hier.total_classes, 128, 128
    lo = torch.randn((B, C, h, w), generator=gen, device=dev) * 3
    nf, nc = hier.n_fine, hier.n_coarse

    # #4: stated tolerance 1e-5 relative per sum (f32 sums of 2.1 M terms
    # in another order; the counts exact); the same bits twice
    got = fused.fused_hiera2_sums_kernel(lo, tf, tc, hier)
    want = fused.fused_hiera2_sums_plain(lo, tf, tc, hier)
    err = (got - want).abs()
    again = torch.equal(got, fused.fused_hiera2_sums_kernel(lo, tf, tc, hier))
    torch.cuda.synchronize()
    if (not bool((err <= 1e-5 * want.abs()).all()) or not torch.equal(got[2:4], want[2:4])
            or not again):
        raise AssertionError(f"hiera2_fused_fwd ({config}): sums {got.tolist()} vs plain "
                             f"{want.tolist()}, same bits twice: {again}")
    nvf, nvc = int(want[2].item()), int(want[3].item())
    # #5 with the cotangents the loss assembly passes (losses/fast.py), then
    # with unit cotangents; stated tolerance rtol 2e-4 (tests/test_pallas_fused.py)
    # and an atol at the cotangents' scale. Unit cotangents: 4e-6, 64 f32
    # roundings of order-1 terms (tests/test_torch_port_cuda.py). The loss
    # assembly's: 1e-7 at config 2's 9 fine classes; its terms shrink as
    # 1/nf (the BCE cotangent 5/(nv·nf), the softmax entries off the label),
    # so the atol scales by 9/nf and stays below the typical |d lo|.
    total = labels.numel()
    gsum = torch.tensor([5.0 / (max(nvf, 1) * nf), 5.0 / (max(nvc, 1) * nc), 0.0, 0.0,
                         1.0 / total, 1.0 / total], device=dev)
    derrs = []
    for g, atol in ((gsum, 1e-7 * 9 / nf), (torch.ones(6, device=dev), 4e-6)):
        dlo = fused.fused_hiera2_grad_kernel(lo, tf, tc, hier, g)
        dwant = fused.fused_hiera2_grad_plain(lo, tf, tc, hier, g)
        derr = (dlo - dwant).abs()
        dagain = torch.equal(dlo, fused.fused_hiera2_grad_kernel(lo, tf, tc, hier, g))
        torch.cuda.synchronize()
        if not bool((derr <= atol + 2e-4 * dwant.abs()).all()) or not dagain:
            raise AssertionError(
                f"hiera2_fused_bwd ({config}, cotangents {g.tolist()}): max |Δ| "
                f"{derr.max().item()}, max |Δ| − rtol·|want| − atol "
                f"{(derr - 2e-4 * dwant.abs() - atol).max().item()} beyond rtol 2e-4, atol "
                f"{atol}, or not the same bits twice ({dagain})")
        derrs.append(derr.max().item())
        del dwant, derr

    def unfused(x):  # the port's own path without the kernels
        lf = resize_bilinear(x, (4 * h, 4 * w))
        return (hiera_bce_two_level_cmajor(lf, tf, tc, hier)
                + _ce_cmajor(lf[:, :nf], tf, hier.ignore_index)
                + _ce_cmajor(lf[:, nf:], tc, hier.ignore_index))

    lo_req = lo.detach().clone().requires_grad_()

    def unfused_fwd_bwd():
        lo_req.grad = None
        unfused(lo_req).backward()

    def fused_fwd_bwd():  # the loss assembly of losses/fast.py over the kernels
        lo_req.grad = None
        s_f, s_c, nv_f, nv_c, ce_f, ce_c = fused.fused_hiera2_loss_sums(lo_req, tf, tc, hier)
        loss = 5.0 * (s_f / (torch.clamp(nv_f, min=1.0) * nf)
                      + s_c / (torch.clamp(nv_c, min=1.0) * nc))
        (loss + ce_f / total + ce_c / total).backward()

    with torch.no_grad():
        unfused_loss = unfused(lo).item()
    g_l = got.tolist()
    fused_loss = (5.0 * (g_l[0] / (max(nvf, 1) * nf) + g_l[1] / (max(nvc, 1) * nc))
                  + (g_l[4] + g_l[5]) / total)
    with torch.no_grad():
        unfused_fwd_ms = time_ms(lambda: unfused(lo), iters=10)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    unfused_both_ms = time_ms(unfused_fwd_bwd, iters=10)
    unfused_peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    torch.cuda.reset_peak_memory_stats()
    fused_both_ms = time_ms(fused_fwd_bwd, iters=10)
    fused_peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    # least work: each input byte read and each output byte written once;
    # per valid pixel the transcendentals an f32 result needs (per level of
    # n classes, forward 3·n+1: an exp and a log per BCE term, n exps + 1
    # log for CE; backward 4·n+1: an exp and a reciprocal per BCE
    # derivative, n exps + 1 log for the log-sum-exp and one exp a softmax
    # entry; the kernels' second log or reciprocal of a term is exact
    # without ε over most of the range, and is not counted) and the 4-tap
    # blend (9 flop per channel)
    px = total
    fwd_mufu = nvf * (3 * nf + 1) + nvc * (3 * nc + 1)
    bwd_mufu = nvf * (4 * nf + 1) + nvc * (4 * nc + 1)
    entries = {}
    for name, fn, plain, mufu, nbytes, e, extra in (
        ("hiera2_fused_fwd", lambda: fused.fused_hiera2_sums_kernel(lo, tf, tc, hier),
         lambda: fused.fused_hiera2_sums_plain(lo, tf, tc, hier), fwd_mufu,
         lo.nbytes + tf.nbytes + tc.nbytes + got.nbytes, err.max().item(),
         {"unfused_ms": unfused_fwd_ms, "unfused_what": "F.interpolate + hierarchy BCE + "
          "2 CE, forward", "loss": fused_loss, "unfused_loss": unfused_loss}),
        ("hiera2_fused_bwd", lambda: fused.fused_hiera2_grad_kernel(lo, tf, tc, hier, gsum),
         lambda: fused.fused_hiera2_grad_plain(lo, tf, tc, hier, gsum), bwd_mufu,
         2 * lo.nbytes + tf.nbytes + tc.nbytes, derrs[0],
         {"max_abs_err_unit_cotangents": derrs[1], "unfused_ms": unfused_both_ms, "unfused_what": "the same, forward + backward",
          "fused_fwd_bwd_ms": fused_both_ms, "unfused_fwd_bwd_peak_mb": unfused_peak,
          "fused_fwd_bwd_peak_mb": fused_peak}),
    ):
        t = {"ms": time_ms(fn), "plain_ms": time_ms(plain, iters=3)}
        b_ms, b_by = bound(nbytes, 9 * C * px, mufu, sm_mhz)
        entries[name] = dict(t, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                             max_abs_err=e, shapes=[[B, C, h, w]], same_bits_twice=True,
                             share_of_bound=b_ms / t["ms"], **extra)
        say("kernels", kernel=name, config=config, shape=[B, C, h, w], dtype="float32",
            bytes=nbytes, mufu_ops=mufu, sm_clock_mhz=sm_mhz, valid_pixels=[nvf, nvc],
            **entries[name])
    del lo, dlo, lo_req
    torch.cuda.empty_cache()
    return entries


def phase_train_kernels(seed: int, sm_mhz: float):
    """The training path's loss kernels: the fused upsample + hierarchy-BCE
    + CE forward and backward (``fused_loss_checks``) at config 2's shapes
    (``[8, 13, 128, 128]``) and at the 150-class config's (``[8, 165, 128,
    128]``), then the RMI Gram kernels (``rmi_kernel_checks``,
    ``rmi_fast_checks``). The depthwise gradients are checked with the
    forward (``depthwise_checks``)."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    results = fused_loss_checks(gen, "example-train-hopper.yaml", sm_mhz)
    results["config150"] = fused_loss_checks(gen, "example-train-150-hopper.yaml", sm_mhz)
    results.update(rmi_kernel_checks(seed))
    results.update(rmi_fast_checks(seed))
    return results


# the RMI term's two paths (kernels against the materialized op), at config
# 3's shapes: the value within JAX's kernel-vs-core tolerance
# (tests/test_rmi_gram_pallas.py: rtol 2e-4); the gradient, whose entries
# are ~1e-7 at 512² (below that test's atol), by its direction and by its
# size: ‖g_kernel − g_op‖ / ‖g_op‖ within that test's gradient rtol, so a
# backward off by a constant factor fails
RMI_VALUE_RTOL = 2e-4
RMI_GRAD_COS_MIN = 0.999
RMI_GRAD_REL_NORM = 5e-3


def _check_gram(name, got, plain, plain64, mag, again, rtol: float = 1e-5):
    """An RMI kernel against its plain version in f64 (a sum of 260,100 f32
    products in cuBLAS's order carries ~1e-4 relative error of its own; the
    kernels' orders carry ~1e-6, a few 1e-6 at worst: #6 adds ≤ 128
    products a thread (4 columns × 32 rows of a tile), a shuffle tree, its
    tiles' lag rows in tile order and then the frame rows in block order;
    #7 ≤ 128 pixels a thread (4 columns × 32 rows), a shuffle tree, its 2
    warps and the tiles in order; #7f 64
    pixels chained in the tensor core, then ≤ 32 rows a warp, 4 warps and
    the tiles in order; #8 ≤ 50 products a pixel): |Δ| ≤ ``rtol`` · mag per
    entry; the f32 plain
    version's own deviation is reported; two runs give the same bits."""
    import torch

    diff = (got.double() - plain64).abs()
    torch.cuda.synchronize()
    if not bool((diff <= rtol * mag).all()):
        raise AssertionError(f"{name}: max |Δ|/mag = {(diff / mag).max().item()} > {rtol}")
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two runs differ")
    plain_dev = ((plain.double() - plain64).abs() / mag.clamp_min(1e-300)).max().item()
    return (diff.max().item(), (diff / mag.clamp_min(1e-300)).max().item(), plain_dev,
            (got - plain).abs().max().item())


def _rmi_maps(gen, B, C, H, W):
    """A one-hot of random labels and sigmoids of random logits + 1e-6,
    both ``[B, C, H, W]`` f32 on the card."""
    import torch
    import torch.nn.functional as F

    labels = torch.randint(0, C, (B, H, W), generator=gen, device="cuda")
    oh_map = F.one_hot(labels, C).permute(0, 3, 1, 2).to(torch.float32).contiguous()
    pr_map = torch.sigmoid(2 * torch.randn((B, C, H, W), generator=gen, device="cuda")) + 1e-6
    return oh_map, pr_map


def _grad_maps_two_call(la, pr, p, precision, want64, mag):
    """Kernel #8's function (``precision="fast"``: #8f's) as two cuDNN calls,
    the yardstick where no one PyTorch call computes it: ``u`` by
    ``conv2d`` of the interleaved maps ``[1, 2·BC, H, W]`` with P as 9 3×3
    filters per map pair (``groups=BC``), then ``conv_transpose2d`` with
    the 9 shift one-hots; under ``fast`` on the bf16-rounded maps and P.
    The inputs are made here, outside any timed region; checked once
    against the plain version in f64 within 1e-5 of Σ|P|·|z| per pixel
    (TF32 is off). Returns the two-call closure."""
    import torch
    import torch.nn.functional as F

    from seghiero_torch.ops import rmi_gram as rg

    BC, H, W = pr.shape
    r = rg.bf16_round if precision == "fast" else (lambda t: t)
    x = torch.stack([r(la), r(pr)], dim=1).reshape(1, 2 * BC, H, W)
    wgt = r(p).reshape(9 * BC, 2, 3, 3)
    shifts = torch.eye(9, device=pr.device).reshape(9, 1, 3, 3).repeat(BC, 1, 1, 1)

    def two():
        return F.conv_transpose2d(F.conv2d(x, wgt, groups=BC), shifts, groups=BC)[0]

    rel = ((two().double() - want64).abs() / mag.clamp_min(1e-300)).max().item()
    if not rel <= 1e-5:
        raise AssertionError(f"two-call cuDNN grad_maps ({precision}): max |Δ|/mag = {rel}")
    return two


def _timed_with_two_call(fn, two):
    """The kernel and the two-call composition timed in turns (kernel,
    two-call, two-call, kernel), each the mean of its two readings."""
    t = [time_ms(fn), time_ms(two), time_ms(two), time_ms(fn)]
    ms, two_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    return {"ms": ms, "cudnn_two_call_ms": two_ms, "kernel_over_cudnn_two_call": ms / two_ms,
            "turns_ms": t}


def rmi_kernel_checks(seed: int):
    """Kernels #6–#8 at config 3's shapes: 60 maps (batch 4 × 15 classes)
    of 512², a one-hot of random labels and sigmoids of random logits
    + 1e-6; W is the regression solved from the kernel's G18 and P the
    backward's, for the RMI term's cotangent 1/(4·9) per half-logdet."""
    import torch

    from seghiero_torch.losses.rmi import rmi_lower_bound_cmajor
    from seghiero_torch.ops import rmi_gram as rg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    B, C, H, W = 4, 15, 512, 512
    BC, n = B * C, (H - 2) * (W - 2)
    oh_map, pr_map = _rmi_maps(gen, B, C, H, W)
    la, pr = oh_map.reshape(BC, H, W), pr_map.reshape(BC, H, W)

    la64, pr64 = la.double(), pr.double()
    check = _check_gram
    # #6: la, pr ≥ 0, so Σ|z_i·z_j| is the Gram itself
    g18 = rg.gram18(la, pr)
    want = rg.gram18_plain(la64, pr64)
    err6 = check("rmi_gram18", g18, rg.gram18_plain(la, pr), want, want, rg.gram18(la, pr))
    # #7: |y| ≤ z_la + |W|ᵀ·z_pr per pixel
    w = rg._solve_w(g18, n)
    a = rg.residual_gram(la, pr, w)
    yb = rg._views(la64) + w.double().abs().mT @ rg._views(pr64)
    err7 = check("rmi_residual_gram", a, rg.residual_gram_plain(la, pr, w),
                 rg.residual_gram_plain(la64, pr64, w.double()), yb @ yb.mT,
                 rg.residual_gram(la, pr, w))
    del yb, want
    # #8: Σ|P|·|z| per pixel
    p = rg.backward_p(g18, w, a, torch.full((BC,), 1.0 / (B * 9), device=dev), n)
    dpr = rg.grad_maps(la, pr, p)
    want = rg.grad_maps_plain(la64, pr64, p.double())
    mag = rg.grad_maps_plain(la64, pr64, p.double().abs())
    err8 = check("rmi_grad_maps", dpr, rg.grad_maps_plain(la, pr, p), want, mag,
                 rg.grad_maps(la, pr, p))
    two8 = _grad_maps_two_call(la, pr, p, "parity", want, mag)
    del la64, pr64, want, mag
    torch.cuda.empty_cache()

    # the RMI term on both paths: value, gradient, and time
    pr_req = pr_map.clone().requires_grad_()

    def term(backend):  # forward + backward, no host sync
        pr_req.grad = None
        v = rmi_lower_bound_cmajor(oh_map, pr_req, backend=backend)
        v.backward()
        return v

    (v_k, g_k), (v_x, g_x) = ((term(b).item(), pr_req.grad.clone()) for b in ("pallas", "xla"))
    g_k, g_x = g_k.flatten().double(), g_x.flatten().double()
    cos = torch.nn.functional.cosine_similarity(g_k, g_x, dim=0).item()
    rel = ((g_k - g_x).norm() / g_x.norm()).item()
    say("kernels", check="RMI term, kernel path vs materialized op", value_kernel=v_k,
        value_library=v_x, value_rel_diff=abs(v_k - v_x) / abs(v_x), value_rtol=RMI_VALUE_RTOL,
        grad_cos=cos, grad_cos_floor=RMI_GRAD_COS_MIN, grad_rel_norm_diff=rel,
        grad_rel_norm_limit=RMI_GRAD_REL_NORM, grad_norm_kernel=g_k.norm().item(),
        grad_norm_library=g_x.norm().item())
    if (abs(v_k - v_x) > RMI_VALUE_RTOL * abs(v_x) or cos < RMI_GRAD_COS_MIN
            or not rel <= RMI_GRAD_REL_NORM):
        raise AssertionError("RMI kernel path and materialized op disagree")
    del g_k, g_x

    def forward(backend):
        with torch.no_grad():
            rmi_lower_bound_cmajor(oh_map, pr_map, backend=backend)

    fwd = {b: time_ms(lambda: forward(b), iters=10) for b in ("pallas", "xla")}
    both = {b: time_ms(lambda: term(b), iters=10) for b in ("pallas", "xla")}
    # least operations, from the shift structure: the 18 views are shifts of
    # two maps, so a G18 entry is a correlation of two maps at one offset in
    # {−2..2}² (la·la and pr·pr 13 offsets each, by symmetry; la·pr 25), up
    # to O(H + W) terms on the 2-pixel frame: 51 FMAs per output pixel for
    # #6. #8's dpr is, inside the frame, a 5×5 correlation of each map with
    # taps folded from P once per map: 50 FMAs per pixel. #7's residual y
    # is needed per pixel for its numerics: 81 FMAs for −y = Wᵀ·z_pr − z_la
    # (summed from −z_la, so no subtraction is left) and 45 for y·yᵀ.
    pixels = BC * n
    out = {}
    for name, fn, plain, nbytes, flops, err, extra in (
        ("rmi_gram18", lambda: rg.gram18(la, pr), lambda: rg.gram18_plain(la, pr),
         la.nbytes + pr.nbytes + g18.nbytes, 2 * 51 * pixels, err6,
         {"unfused_ms": fwd["xla"], "kernel_path_ms": fwd["pallas"],
          "unfused_what": "RMI term forward, rmi_backend: xla (materialized views) against "
          "pallas (kernel_path_ms)"}),
        ("rmi_residual_gram", lambda: rg.residual_gram(la, pr, w),
         lambda: rg.residual_gram_plain(la, pr, w),
         la.nbytes + pr.nbytes + w.nbytes + a.nbytes, 2 * (81 + 45) * pixels, err7,
         {"unfused_ms": fwd["xla"], "kernel_path_ms": fwd["pallas"],
          "unfused_what": "the same forward"}),
        ("rmi_grad_maps", lambda: rg.grad_maps(la, pr, p), lambda: rg.grad_maps_plain(la, pr, p),
         la.nbytes + pr.nbytes + p.nbytes + dpr.nbytes, 2 * 50 * BC * H * W, err8,
         {"unfused_ms": both["xla"], "kernel_path_ms": both["pallas"],
          "unfused_what": "RMI term forward + backward, xla against pallas (kernel_path_ms)"}),
    ):
        t = _timed_with_two_call(fn, two8) if name == "rmi_grad_maps" else {"ms": time_ms(fn)}
        t["plain_ms"] = time_ms(plain, iters=3)
        b_ms, b_by = bound(nbytes, flops)
        out[name] = dict(t, library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=err[0],
                         shapes=[[BC, H, W]], **extra)
        say("kernels", kernel=name, shape=[BC, H, W], dtype="float32", bytes=nbytes, flops=flops,
            max_rel_err_of_mag=err[1], plain_f32_max_rel_err_of_mag=err[2],
            max_abs_diff_vs_plain_f32=err[3], share_of_bound=b_ms / t["ms"], **out[name])
    del pr_req, oh_map, pr_map, la, pr, g18, a, dpr, two8
    torch.cuda.empty_cache()
    return out


# kernels #6f–#8f (``rmi_precision: fast``) against their plain versions in
# f64 after the same bf16 roundings. #6f and #8f round only their inputs,
# identically on both sides, so they differ from the f64 sums by f32 order
# alone, as #6 and #8 do: 1e-5 of the magnitude. #7f also rounds the
# residual y from the tensor core's sum of la and 9 exact products, which
# lands on the other side of a bf16 rounding boundary than the f64 sum for
# about 1 in 10^4 values (a few 2^-24 of a 2^-8 spacing); each such flip
# moves one pixel's products by 2^-8 of themselves, about 1e-6 of the
# magnitude in all; and the tensor core adds y·yᵀ in its own order with
# truncation, chained over 64 pixels (a few 1e-7 a row, then f32 adds):
# 2e-5 leaves room for all three.
RMI_FAST_RTOL = {"rmi_gram18_fast": 1e-5, "rmi_residual_gram_fast": 2e-5,
                 "rmi_grad_maps_fast": 1e-5}
# the RMI term through the fast kernels against the parity kernels: the
# value within the JAX package's fast-vs-parity tolerance
# (tests/test_rmi_gram_pallas.py:75, rtol 2e-2); the gradient, P·z with P
# and z rounded to bf16 (at most 2^-9 relative each, P's rounding the same
# for every pixel of a map), within 2e-2 of the parity gradient's norm
# (five bf16 half-ulps) and at a cosine of 0.999
RMI_FAST_VALUE_RTOL = 2e-2
RMI_FAST_GRAD_COS_MIN = 0.999
RMI_FAST_GRAD_REL_NORM = 2e-2


def _rmi_term_routes(oh_map, pr_map, routes):
    """The RMI term (``rmi_lower_bound_cmajor``) on each route, forward and
    backward: value, gradient, device ms and the peak memory above the
    inputs it allocated."""
    import torch

    from seghiero_torch.losses.rmi import rmi_lower_bound_cmajor

    pr_req = pr_map.clone().requires_grad_()
    out = {}
    for route, kw in routes.items():
        def term():  # forward + backward, no host sync
            pr_req.grad = None
            v = rmi_lower_bound_cmajor(oh_map, pr_req, **kw)
            v.backward()
            return v

        pr_req.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        value = term().item()
        peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
        grad = pr_req.grad.flatten().double()
        out[route] = {"value": value, "grad": grad, "peak_mb_above_inputs": peak_mb,
                      "fwd_bwd_ms": time_ms(term, iters=5, warmup=1)}
    return out


def _agree(a, b):
    """(value rel diff, gradient cosine, ‖g_a − g_b‖/‖g_b‖) of two routes."""
    import torch

    cos = torch.nn.functional.cosine_similarity(a["grad"], b["grad"], dim=0).item()
    rel = ((a["grad"] - b["grad"]).norm() / b["grad"].norm()).item()
    return abs(a["value"] - b["value"]) / abs(b["value"]), cos, rel


def rmi_fast_checks(seed: int):
    """Kernels #6f–#8f at config 4's shapes: 30 maps (batch 2 × 15 classes)
    of 769² (767 output rows and columns: ragged against the 32-row,
    128-column blocks), made as ``rmi_kernel_checks`` makes them; each
    timed beside its f32 twin at the same shapes. Then the RMI term at
    those shapes on four routes: the fast kernels, the parity kernels, the
    materialized op and the streaming path."""
    import torch

    from seghiero_torch.ops import rmi_gram as rg

    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    B, C, H, W = 2, 15, 769, 769
    BC, n = B * C, (H - 2) * (W - 2)
    oh_map, pr_map = _rmi_maps(gen, B, C, H, W)
    la, pr = oh_map.reshape(BC, H, W), pr_map.reshape(BC, H, W)
    la64, pr64 = la.double(), pr.double()
    F_ = "fast"
    tol = RMI_FAST_RTOL

    g18 = rg.gram18(la, pr, F_)
    want = rg.gram18_plain(la64, pr64, F_)  # la, pr ≥ 0: its own magnitude
    err6 = _check_gram("rmi_gram18_fast", g18, rg.gram18_plain(la, pr, F_), want, want,
                       rg.gram18(la, pr, F_), tol["rmi_gram18_fast"])
    w = rg._solve_w(g18, n)
    a = rg.residual_gram(la, pr, w, F_)
    yb = (rg._views(rg.bf16_round(la64))
          + rg.bf16_round(w.double()).abs().mT @ rg._views(rg.bf16_round(pr64)))
    err7 = _check_gram("rmi_residual_gram_fast", a, rg.residual_gram_plain(la, pr, w, F_),
                       rg.residual_gram_plain(la64, pr64, w.double(), F_), yb @ yb.mT,
                       rg.residual_gram(la, pr, w, F_), tol["rmi_residual_gram_fast"])
    del yb, want
    p = rg.backward_p(g18, w, a, torch.full((BC,), 1.0 / (B * 9), device="cuda"), n)
    dpr = rg.grad_maps(la, pr, p, F_)
    want = rg.grad_maps_plain(la64, pr64, p.double(), F_)
    mag = rg.grad_maps_plain(la64, pr64, p.double().abs(), F_)
    err8 = _check_gram("rmi_grad_maps_fast", dpr, rg.grad_maps_plain(la, pr, p, F_), want, mag,
                       rg.grad_maps(la, pr, p, F_), tol["rmi_grad_maps_fast"])
    two8 = _grad_maps_two_call(la, pr, p, F_, want, mag)
    del la64, pr64, want, mag
    torch.cuda.empty_cache()

    # least work as for #6–#8 (rmi_kernel_checks), the products on bf16
    # operands at the tensor cores' bf16 rate: all three bound by bytes
    pixels = BC * n
    out = {}
    for name, args, fn, nbytes, flops, err in (
        ("rmi_gram18_fast", (la, pr), rg.gram18, la.nbytes + pr.nbytes + g18.nbytes,
         2 * 51 * pixels, err6),
        ("rmi_residual_gram_fast", (la, pr, w), rg.residual_gram,
         la.nbytes + pr.nbytes + w.nbytes + a.nbytes, 2 * (81 + 45) * pixels, err7),
        ("rmi_grad_maps_fast", (la, pr, p), rg.grad_maps,
         la.nbytes + pr.nbytes + p.nbytes + dpr.nbytes, 2 * 50 * BC * H * W, err8),
    ):
        plain = getattr(rg, fn.__name__ + "_plain")
        t = (_timed_with_two_call(lambda: fn(*args, F_), two8) if name == "rmi_grad_maps_fast"
             else {"ms": time_ms(lambda: fn(*args, F_))})
        t.update(plain_ms=time_ms(lambda: plain(*args, F_), iters=3),
                 f32_twin_ms=time_ms(lambda: fn(*args)))
        b_ms, b_by = bound(nbytes, flops, flops_per_s=H100_BF16_FLOPS)
        out[name] = dict(t, library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=err[0],
                         shapes=[[BC, H, W]])
        say("kernels", kernel=name, shape=[BC, H, W], views="bfloat16", bytes=nbytes,
            flops=flops, tolerance_of_mag=tol[name], max_rel_err_of_mag=err[1],
            plain_f32_max_rel_err_of_mag=err[2], max_abs_diff_vs_plain_f32=err[3],
            share_of_bound=b_ms / t["ms"], **out[name])
    del la, pr, g18, a, dpr, two8
    torch.cuda.empty_cache()

    # the RMI term at config 4's shapes on four routes
    routes = _rmi_term_routes(oh_map, pr_map, {
        "fast kernels": {"backend": "pallas", "precision": "fast"},
        "parity kernels": {"backend": "pallas"},
        "materialized op": {"backend": "xla", "streaming": "off"},
        "streaming": {"backend": "xla", "streaming": "on"},
    })
    checks = (("parity kernels", "materialized op", RMI_VALUE_RTOL, RMI_GRAD_COS_MIN,
               RMI_GRAD_REL_NORM),
              ("streaming", "materialized op", RMI_VALUE_RTOL, RMI_GRAD_COS_MIN,
               RMI_GRAD_REL_NORM),
              ("fast kernels", "parity kernels", RMI_FAST_VALUE_RTOL, RMI_FAST_GRAD_COS_MIN,
               RMI_FAST_GRAD_REL_NORM))
    failed = []
    for a_, b_, v_tol, cos_min, rel_max in checks:
        v_rel, cos, rel = _agree(routes[a_], routes[b_])
        say("kernels", check=f"RMI term at config 4's shapes, {a_} vs {b_}",
            shape=[B, C, H, W], value=routes[a_]["value"], value_ref=routes[b_]["value"],
            value_rel_diff=v_rel, value_rtol=v_tol, grad_cos=cos, grad_cos_floor=cos_min,
            grad_rel_norm_diff=rel, grad_rel_norm_limit=rel_max)
        if v_rel > v_tol or cos < cos_min or not rel <= rel_max:
            failed.append(f"{a_} vs {b_}")
    say("kernels", check="RMI term at config 4's shapes, forward + backward per route",
        **{r: {k: v for k, v in d.items() if k != "grad"} for r, d in routes.items()})
    if routes["streaming"]["peak_mb_above_inputs"] >= \
            routes["materialized op"]["peak_mb_above_inputs"]:
        failed.append("streaming route uses no less memory than the materialized op")
    if failed:
        raise AssertionError(f"RMI term routes disagree: {failed}")
    for name in out:
        out[name]["rmi_term_fwd_bwd_ms"] = {r: d["fwd_bwd_ms"] for r, d in routes.items()}
    del routes, oh_map, pr_map
    torch.cuda.empty_cache()
    return out


def _post(url: str, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST")
    req.add_header("Content-Type", "application/octet-stream")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        data = r.read()
        status = r.status
    return status, data, (time.perf_counter() - t0) * 1e3


# ---------------------------------------------------------------------------
def phase_serve(seed: int, n_requests: int, device_line: str):
    import torch
    import yaml

    from hbench.core import predictlib
    from hbench.reference import model as reference
    from hbench.reference.tree import from_classes
    from seghiero_torch import ops
    from seghiero_torch.serve import ServingModel, make_server

    port = yaml.safe_load((ROOT / "configs" / "example-serving-hopper.yaml").read_text())
    if (port["model"]["depthwise_backend"], port["model"]["argmax_backend"]) != ("pallas",
                                                                                  "pallas"):
        raise AssertionError("the serving config must select both kernels")
    t0 = time.perf_counter()
    # the benchmark's seeded weights, BatchNorm statistics calibrated once
    sd = predictlib.seeded_weights(reference, port, from_classes(port["classes"]), seed, "cuda")
    predictor = predictlib.predictor(port, sd, "cuda")
    cfg = predictor.cfg
    setup_s = time.perf_counter() - t0

    class RecordingModel(ServingModel):
        """Keeps every device batch the dispatcher forms, with its masks and
        its wall time (H2D, forward, decode, D2H) on the dispatcher thread."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.batches = []
            self.batch_ms = []

        def predict(self, images_u8):
            t0 = time.perf_counter()
            out = super().predict(images_u8)
            self.batch_ms.append((len(images_u8), (time.perf_counter() - t0) * 1e3))
            self.batches.append((images_u8.copy(), out))
            return out

    model = RecordingModel(predictor)
    server = make_server(model, port=0, max_batch=8, batch_timeout_ms=20.0)
    model.batches.clear()  # the dispatcher's warm-up batches
    model.batch_ms.clear()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(seed)
    hw = cfg.transform.resize
    # two bursts of distinct images: the first one after start-up, the
    # second one with the server already warm
    n_total = N_BURSTS * n_requests
    images = rng.integers(0, 256, (n_total, *hw, 3), dtype=np.uint8)
    bodies = []
    for img in images:
        buf = io.BytesIO()
        np.save(buf, img)
        bodies.append(buf.getvalue())
    responses = [None] * n_total
    errors = []

    def call(i):
        try:
            responses[i] = _post(url + "/predict?format=npz", bodies[i])
        except Exception as e:  # reported below; the phase then fails
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    threads, burst_s, burst_batch_ms = [], [], []
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        before = ops.launch_counts()
        for burst in range(N_BURSTS):
            t_burst = time.perf_counter()
            group = [threading.Thread(target=call, args=(i,))
                     for i in range(burst * n_requests, (burst + 1) * n_requests)]
            for t in group:
                t.start()
            for t in group:
                t.join(timeout=600)
            burst_s.append(time.perf_counter() - t_burst)
            threads += group
            burst_batch_ms.append(model.batch_ms[sum(len(b) for b in burst_batch_ms):])
        after = ops.launch_counts()
        launches = {name: after[key] - before[key] for name, key in (
            ("depthwise3x3", "seghiero_torch.ops.depthwise.launches"),
            ("depthwise3x3_dilated", "seghiero_torch.ops.depthwise.dilated_launches"),
            ("upsample_argmax", "seghiero_torch.ops.upsample_argmax.launches"))}
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
        server.batcher.stop()
        server.server_close()
        thread.join(timeout=30)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"serving failed: {errors or 'requests still running'}")

    # every response equals the predictor called directly on its batch
    n_batches = len(model.batches)
    masks = {}
    for i, (status, data, _) in enumerate(responses):
        if status != 200:
            raise AssertionError(f"request {i}: HTTP {status}")
        with np.load(io.BytesIO(data)) as z:
            masks[i] = {k: z[k] for k in z.files}
    h = cfg.hierarchy
    n_classes = {"fine": h.n_fine, "coarse": h.n_coarse}
    for batch, _ in model.batches:
        direct = predictor.predict_array(batch)
        for j, img in enumerate(batch):
            (i,) = [k for k in range(n_total) if np.array_equal(images[k], img)]
            for lvl, n in n_classes.items():
                got = masks[i][lvl]
                if got.shape != tuple(hw) or got.dtype != np.uint8 or got.max() >= n:
                    raise AssertionError(f"request {i} {lvl}: bad mask {got.shape} {got.dtype}")
                if not np.array_equal(got, direct[lvl][j]):
                    raise AssertionError(f"request {i} {lvl}: differs from direct predictor")
    n_dilated = len(cfg.model.dilations) - 1  # the ASPP's separable branches
    if (launches["depthwise3x3"] != 2 * n_batches or launches["upsample_argmax"] != n_batches
            or launches["depthwise3x3_dilated"] != n_dilated * n_batches):
        raise AssertionError(f"launches {launches} for {n_batches} device batches")
    with torch.inference_mode():
        finite = bool(torch.isfinite(predictor.logits(images[:8])).all().item())
    if not finite:
        raise AssertionError("non-finite logits")

    # the library-op path (both backends xla) on the same card and weights
    port_xla = dict(port, model=dict(port["model"], depthwise_backend="xla",
                                     argmax_backend="xla"))
    predictor_xla = predictlib.predictor(port_xla, sd, "cuda")
    # on the same device batches as the server formed: cuDNN's bf16
    # backbone then computes the same bits on both paths, and only the two
    # swapped functions differ (depthwise: f32 sums in another order,
    # rounded to bf16; decode: another multiply-add order in f32) — a
    # difference the rest of the bf16 head can carry to an argmax flip
    # only where two logits are within a few bf16 ulps
    agree = {lvl: [] for lvl in n_classes}
    for batch, served in model.batches:
        ref = predictor_xla.predict_array(batch)
        for lvl in n_classes:
            agree[lvl] += [float((served[lvl][j] == ref[lvl][j]).mean())
                           for j in range(len(batch))]
    worst = {lvl: min(v) for lvl, v in agree.items()}
    if min(worst.values()) < AGREE_MIN:
        raise AssertionError(f"kernel path vs library path agreement {worst} < {AGREE_MIN}")
    # informational: the same comparison at another batch composition
    # (cuDNN may pick other algorithms per batch size; with seeded random
    # weights the bf16 rounding differences grow through the 50 layers)
    across = {lvl: [] for lvl in n_classes}
    for start in range(0, n_total, 8):
        ref = predictor_xla.predict_array(images[start:start + 8])
        for j in range(ref["fine"].shape[0]):
            for lvl in n_classes:
                across[lvl].append(float((masks[start + j][lvl] == ref[lvl][j]).mean()))

    lat = [sorted(r[2] for r in responses[b * n_requests:(b + 1) * n_requests])
           for b in range(N_BURSTS)]
    batch_ms = time_ms(lambda: predictor.predict_masks(images[:8]), iters=10, warmup=2)
    batch_ms_xla = time_ms(lambda: predictor_xla.predict_masks(images[:8]), iters=10, warmup=2)
    say("serve", requests=n_total, bursts=N_BURSTS, device_batches=n_batches,
        batch_sizes=stats["batch_sizes"], launches=launches,
        dispatcher_batch_ms_by_burst=burst_batch_ms,
        min_pixel_agreement_vs_library=worst,
        min_pixel_agreement_vs_library_at_batch8={k: min(v) for k, v in across.items()},
        p50_latency_ms_by_burst=[v[len(v) // 2] for v in lat],
        max_latency_ms_by_burst=[v[-1] for v in lat],
        images_per_s_by_burst=[n_requests / t for t in burst_s],
        predict_b8_ms=batch_ms, predict_b8_library_ms=batch_ms_xla,
        setup_s=round(setup_s, 2), healthz=health, card=device_line)


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this run needs the card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    name, count, smi, sm_mhz = phase_device()
    phase_build()
    kernels = phase_kernels(SEED)
    kernels.update(phase_train_kernels(SEED, sm_mhz))
    t_kernels = time.perf_counter()
    phase_serve(SEED, N_REQUESTS, smi)
    say("elapsed", seconds_to_kernels_end=round(t_kernels - t_start, 1),
        serve_s=round(time.perf_counter() - t_kernels, 1),
        total_s=round(time.perf_counter() - t_start, 1))
    sources = {
        "depthwise3x3": ("seghiero_torch/csrc/depthwise3x3.cu",
                         "seghiero_tpu/ops/pallas/depthwise.py:221"),
        "depthwise3x3_dgrad": ("seghiero_torch/csrc/depthwise3x3.cu",
                               "seghiero_tpu/ops/pallas/depthwise.py:292"),
        "depthwise3x3_wgrad": ("seghiero_torch/csrc/depthwise3x3_wgrad.cu",
                               "seghiero_tpu/ops/pallas/depthwise.py:245"),
        "depthwise3x3_dilated": ("seghiero_torch/csrc/depthwise3x3_dilated.cu",
                                 "no pallas_call: XLA's grouped conv, "
                                 "seghiero_tpu/models/heads.py:101-111"),
        "hiera2_fused_fwd": ("seghiero_torch/csrc/hiera2_fused.cu",
                             "seghiero_tpu/ops/pallas/hiera2_fused.py:322"),
        "hiera2_fused_bwd": ("seghiero_torch/csrc/hiera2_fused.cu",
                             "seghiero_tpu/ops/pallas/hiera2_fused.py:348"),
        "sr_attention_fwd": ("seghiero_torch/csrc/sr_attention.cu",
                             "no pallas_call: two einsums and a softmax, "
                             "seghiero_tpu/models/mit.py EfficientAttention"),
        "sr_attention_bwd": ("seghiero_torch/csrc/sr_attention.cu",
                             "no pallas_call: the einsums' gradients, "
                             "seghiero_tpu/models/mit.py EfficientAttention"),
        "upsample_argmax": ("seghiero_torch/csrc/upsample_argmax.cu",
                            "seghiero_tpu/ops/pallas/upsample_argmax.py:153"),
        "rmi_gram18": ("seghiero_torch/csrc/rmi_gram.cu",
                       "seghiero_tpu/ops/pallas/rmi_gram.py:257"),
        "rmi_residual_gram": ("seghiero_torch/csrc/rmi_gram.cu",
                              "seghiero_tpu/ops/pallas/rmi_gram.py:274"),
        "rmi_grad_maps": ("seghiero_torch/csrc/rmi_gram.cu",
                          "seghiero_tpu/ops/pallas/rmi_gram.py:297"),
    }
    # #6f–#8f: the same pallas_calls built with bf16 views (zdt = bfloat16,
    # rmi_gram.py:416-443), config 4's path
    for kname in ("rmi_gram18", "rmi_residual_gram", "rmi_grad_maps"):
        sources[kname + "_fast"] = sources[kname]
    line = []
    for kname, (src, replaces) in sources.items():
        k = kernels[kname]
        line.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            **({"instantiation": "bf16 views (training.rmi_precision: fast)",
                "f32_twin_ms": k["f32_twin_ms"]} if kname.endswith("_fast") else {}),
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "shapes": k["shapes"],
            **{x: k[x] for x in ("graph_ms", "library_graph_ms", "unfused_ms", "unfused_what",
                                 "by_dilation", "by_shape",
                                 "kernel_path_ms", "kernel_over_library", "cudnn_two_call_ms",
                                 "kernel_over_cudnn_two_call") if x in k},
            # the depthwise kernels also at config 4's shapes, #1 and #3 at
            # config 5's, the fused loss at the 150-class config's
            **{c: kernels[c][kname] for c in ("config4", "config5", "config150")
               if kname in kernels[c]},
            # the decode also in bf16, the dtype of the serving model's logits
            **({"bfloat16": k["bfloat16"]} if "bfloat16" in k else {}),
        })
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
