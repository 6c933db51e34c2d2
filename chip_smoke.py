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
   depthwise kernels also at config 4's shapes (193², odd); the dilated
   depthwise forward (#9) at the served ASPP input ``[4, 128, 128, 2048]``
   bf16 at dilations 12 / 24 / 36, beside ``F.conv2d(groups=C,
   dilation=d)``; the decode
   in f32 and bf16, eagerly (as a served batch launches it) and by
   CUDA-graph replay (the kernel alone: it is shorter than a launch's
   host cost); the fused
   loss kernels also at the 150-class config's (``[8, 165, 128, 128]``);
   the RMI Gram
   kernels at config 3's shapes (f32) and their bf16-view variants at
   config 4's (beside the f32 kernels' times there), #8 / #8f also in
   turns with the same function as two cuDNN calls, then the RMI term at
   config 4's shapes on four routes (fast kernels, parity kernels,
   materialized op, streaming), value, gradient, time and memory;
4. serve   — ``configs/example-serving-hopper.yaml`` at full width with
   weights made from a fixed seed: the port's ``ServingModel`` +
   ``make_server`` answer two bursts of concurrent 512×512 requests on a
   local port; each response must equal the predictor called directly on
   the same batch, the library-op predictor (both backends ``xla``) must
   agree on ≥99.5% of pixels per level, and each kernel's launch counter
   must show the serving run went through it;
4b. infer5 — ``configs/example-serving-3level-r101-hopper.yaml`` (BASELINE
   config 5: ResNet-101, 3 levels, 1024², batch 4, bf16) at full width and
   depth: the depthwise forward (#1) and the decode (#3) at its shapes
   against their plain versions, timed; weights from the seed saved as a
   port checkpoint directory (``best.json``); the port's infer CLI
   (``python -m seghiero_torch.infer``, in-process, no ``--checkpoint``) on
   8 PNGs of 1024² and 3 of 1280×960, whose written masks must equal
   ``Predictor.predict_array`` on the same batches; the batch-4
   ``predict_masks`` time; a sliding window over a 1536×2048 image (6
   windows of 1024²) and TTA at scales 0.75 / 1.0 / 1.25 with flip — every
   run's masks within 99.5 % per level of the library-op predictor's, and
   its launches exactly 2 of #1 and 3 of #9 per forward and 1 of #3 per
   1024² batch (none in the 1280×960 group, the sliding window or TTA);
5. train   — ``configs/example-train-hopper.yaml`` (ResNet-50, 512², batch
   8, bf16) with weights made from the seed: the kernel path against the
   library path (``depthwise_backend: xla``, ``pallas_fused_loss: false``)
   on one batch (loss, per-parameter gradient cosine); both paths' device
   step time; then ``Trainer.fit()`` — one epoch of SGD steps, each with
   exactly 2/2/2/1/1 launches of the depthwise forward, input gradient,
   weight gradient, fused loss forward and backward, a finite loss, and on
   step 1 a finite gradient for every parameter — the evaluation pass and
   a checkpoint, restored into a fresh ``Trainer`` whose eval loss must be
   the same bits;
5b. trainfiles — ``configs/example-train-files-hopper.yaml``: config 2
   trained from files. It writes 64 train and 16 val image / mask PNGs of
   1024×2048 (the synthetic shapes at the seed) and the seeded backbone as
   a torchvision-layout ResNet-50 ``.pth`` into a temporary directory,
   prebuilds the raw cache with ``python -m seghiero_torch.data.cache``'s
   ``main`` in process, and checks that the ``Trainer``'s backbone holds
   the ``.pth``'s tensors, that the first train batch from the cache equals
   the uncached dataset's bit for bit, and that the native transforms equal
   their plain versions on those images; then the checks of ``train`` with
   the native transforms, scale-crop, colour jitter, the flip on the card,
   the backbone at a tenth of the learning rate, no decay on norm and bias
   and the gradient norm clipped, each ``fit`` step with exactly 2/2/2/1/1
   launches; then one line setting its loop images/s and loader ms per
   batch beside ``train``'s;
5c. train150 — ``configs/example-train-150-hopper.yaml`` (config 2 with
   the 150 + 15 classes of ``example-many-classes.yaml``), the same checks
   as ``train`` against its library path (``pallas_fused_loss: false``),
   each ``fit`` step with exactly 2/2/2/1/1 launches;
6. train3  — ``configs/example-train-3level-hopper.yaml`` (BASELINE config
   3: ResNet-50, 3-level hierarchy of 15 classes, 512², batch 4, bf16), the
   same checks against the library path (``depthwise_backend: xla``,
   ``rmi_backend: xla``), each ``fit`` step with exactly 2/2/2 depthwise
   launches and 1/1/1 of the RMI Gram kernels, the evaluation's fine,
   coarse and super mIoU, and the checkpoint round trip;
7. train4  — ``configs/example-train-r101-769-hopper.yaml`` (BASELINE
   config 4 on one card: ResNet-101, the same hierarchy, 769², batch 2,
   bf16, ``rmi_precision: fast``): on one batch the parity kernel path
   against the library path, and the fast kernel path against the parity
   kernel path; the three paths' device step times; each ``fit`` step with
   exactly 2/2/2 depthwise launches and 1/1/1 of the bf16-view RMI kernels
   #6f–#8f (none of #6–#8), eval at three levels, checkpoint round trip.

Then one JSON line ``{"kernels": [...]}``, the ``nvidia-smi`` name/power
line, and as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import subprocess
import sys
import tempfile
import threading
import types
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
    # config 4's, which the kernels line carries beside them
    results.update(depthwise_checks(gen, DW_SHAPES["config 2"]))
    results["config4"] = depthwise_checks(gen, DW_SHAPES["config 4"])
    results["depthwise3x3_dilated"] = dilated_checks(gen)

    # fused 4× upsample + per-level argmax at the serving decode shape, in f32
    # and in bf16 (the serving model's logits)
    results["upsample_argmax"] = decode_checks(gen)
    return results


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


# ---------------------------------------------------------------------------
def random_init_(model, generator):
    """Fill every parameter from ``generator``: convs lecun-normal (std
    1/√fan_in, the JAX package's init), biases and BN shifts N(0, 0.1²),
    BN scales U(0.5, 1.5)."""
    import math

    import torch

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Conv2d):
                std = 1.0 / math.sqrt(mod.weight[0].numel())
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator) * std)
                if mod.bias is not None:
                    mod.bias.copy_(torch.randn(mod.bias.shape, generator=generator) * 0.1)
            elif isinstance(mod, torch.nn.BatchNorm2d):
                mod.weight.copy_(torch.rand(mod.weight.shape, generator=generator) + 0.5)
                mod.bias.copy_(torch.randn(mod.bias.shape, generator=generator) * 0.1)
    return model


def made_up_checkpoint(cfg, seed: int):
    """Full-width weights from ``seed``, with BatchNorm statistics set from
    one train-mode pass over random images (momentum 1), so activations
    keep a realistic scale through all 50 layers."""
    import torch

    from seghiero_torch.data.pipeline import normalize_images
    from seghiero_torch.models.convert import reference_checkpoint
    from seghiero_torch.models.segmenter import build_model

    gen = torch.Generator().manual_seed(seed)
    model = random_init_(build_model(cfg), gen)
    for mod in model.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.momentum = 1.0
    model = model.to("cuda", memory_format=torch.channels_last).train()
    hw = cfg.transform.resize
    imgs = torch.randint(0, 256, (4, *hw, 3), generator=gen, dtype=torch.uint8)
    with torch.no_grad():
        x = normalize_images(imgs.cuda(), cfg.transform.normalize_mean,
                             cfg.transform.normalize_std)
        model(x.permute(0, 3, 1, 2))
    return reference_checkpoint(model.eval())


def _post(url: str, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST")
    req.add_header("Content-Type", "application/octet-stream")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        data = r.read()
        status = r.status
    return status, data, (time.perf_counter() - t0) * 1e3


def phase_serve(seed: int, n_requests: int, device_line: str):
    import torch

    from seghiero_torch.config import load_config
    from seghiero_torch.infer.predictor import Predictor
    from seghiero_torch.ops import depthwise, upsample_argmax
    from seghiero_torch.serve import ServingModel, make_server

    cfg = load_config(str(ROOT / "configs" / "example-serving-hopper.yaml"))
    if (cfg.model.depthwise_backend, cfg.model.argmax_backend) != ("pallas", "pallas"):
        raise AssertionError("the serving config must select both kernels")
    t0 = time.perf_counter()
    ckpt = made_up_checkpoint(cfg, seed)
    predictor = Predictor(cfg, ckpt, device="cuda")
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
        depthwise.launches = 0
        depthwise.dilated_launches = 0
        upsample_argmax.launches = 0
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
        launches = {"depthwise3x3": depthwise.launches,
                    "depthwise3x3_dilated": depthwise.dilated_launches,
                    "upsample_argmax": upsample_argmax.launches}
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
    cfg_xla = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, depthwise_backend="xla", argmax_backend="xla"))
    predictor_xla = Predictor(cfg_xla, ckpt, device="cuda")
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
    # (cuDNN may pick other algorithms per batch size; with made-up
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
    return launches


# config 5 (bench.py:88): the inference phase's config, its decode shape
# and levels, and its image sets: the CLI's two size groups, the sliding
# window's image, window and stride, and TTA's scales
INFER5_CONFIG = "example-serving-3level-r101-hopper.yaml"
DECODE5 = ((4, 15, 256, 256), ((0, 9), (9, 13), (13, 15)))
CLI_IMAGES = {(1024, 1024): 8, (960, 1280): 3}  # (H, W): count
SLIDING = {"hw": (1536, 2048), "window": (1024, 1024), "stride": (512, 512), "windows": 6}
TTA_SCALES = (0.75, 1.0, 1.25)


def _event_ms(fn, n: int = 10, warmup: int = 2):
    """Device ms of each of ``n`` calls of ``fn`` after ``warmup`` calls,
    from CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    events = []
    for _ in range(n):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        fn()
        ev[1].record()
        events.append(ev)
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events]


def _levels_agree(a, b):
    """Per level, the smallest share over the batch's images of pixels
    where the two masks agree."""
    return {lvl: min(float((a[lvl][j] == b[lvl][j]).mean()) for j in range(len(a[lvl])))
            for lvl in a}


def _counted(fn, want):
    """Run ``fn`` with the launch counters set to 0; the counts it made,
    which must equal ``want`` for each kernel ``want`` names."""
    zero_counts()
    out = fn()
    counts = read_counts()
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"launches {counts}, want {want}")
    return out, counts


def phase_infer5(seed: int, device_line: str):
    """Config 5's inference (ResNet-101, 3 levels, 1024², batch 4, bf16) at
    full width and depth: the kernels #1 and #3 at its shapes against their
    plain versions; weights from ``seed`` saved as a port checkpoint
    directory; then the port's infer CLI on PNGs of two sizes, the batch-4
    ``predict_masks`` time, the sliding window and TTA, each checked
    against the library-op predictor on the same batches. Returns (the
    kernels' config-5 entries, the launch counts of the phase's runs)."""
    import contextlib
    import tempfile

    import torch
    import yaml
    from PIL import Image

    from seghiero_torch.config import load_config
    from seghiero_torch.infer.__main__ import main as infer_main
    from seghiero_torch.infer.predictor import Predictor, preprocess_image
    from seghiero_torch.models.convert import load_reference_checkpoint
    from seghiero_torch.models.segmenter import build_model
    from seghiero_torch.train.checkpoint import CheckpointManager

    torch.cuda.empty_cache()  # what the previous phase left cached
    cfg = load_config(str(ROOT / "configs" / INFER5_CONFIG))
    m, h = cfg.model, cfg.hierarchy
    if ((m.depth, m.dtype, m.depthwise_backend, m.argmax_backend, tuple(cfg.transform.resize),
         cfg.training.batch_size, h.has_super, h.total_classes)
            != (101, "bfloat16", "pallas", "pallas", (1024, 1024), 4, True, 15)):
        raise AssertionError("the infer5 config must be config 5 with both kernels on")
    levels = ("fine", "coarse", "super")

    # -- #1 and #3 at config 5's shapes against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k5 = depthwise_checks(gen, DW_SHAPES["config 5"], timed=("depthwise3x3",))
    k5["upsample_argmax"] = decode_checks(gen, *DECODE5)

    with tempfile.TemporaryDirectory(prefix="chip-smoke-infer5-") as tmp:
        tmp = Path(tmp)
        # -- weights from the seed, saved as the port trainer saves them
        t0 = time.perf_counter()
        weights = made_up_checkpoint(cfg, seed)
        model = load_reference_checkpoint(build_model(cfg), weights)
        cfg = dataclasses.replace(cfg, output=dataclasses.replace(
            cfg.output, checkpoint_dir=str(tmp / "ckpt")))
        raw = dict(cfg.raw, output={"checkpoint_dir": cfg.output.checkpoint_dir,
                                    "project_name": cfg.output.project_name})
        CheckpointManager(cfg.output.checkpoint_dir, cfg.output.project_name).save(
            model, torch.optim.SGD(model.parameters(), lr=0.0), None, step=1, epoch=1,
            metrics={}, best_val_loss=0.0, config_raw=raw, is_best=True)
        del model
        cfg_path = tmp / "config.yaml"
        cfg_path.write_text(yaml.safe_dump(raw))
        predictor = Predictor.from_checkpoint(cfg, None, device="cuda")  # best.json, as the CLI
        cfg_xla = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, depthwise_backend="xla", argmax_backend="xla"))
        predictor_xla = Predictor(cfg_xla, weights, device="cuda")
        rng = np.random.default_rng(seed)
        images = tmp / "images"
        images.mkdir()
        for (H, W), n in CLI_IMAGES.items():
            for i in range(n):
                Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(
                    images / f"img{W}x{H}_{i}.png")
        setup_s = time.perf_counter() - t0

        # -- the CLI, in-process: every image in batches of 4 per size group
        out_dir = tmp / "out"
        size = tuple(cfg.transform.resize)  # the group the fused decode takes
        n_fused = -(-CLI_IMAGES[size] // 4)
        n_batches = sum(-(-n // 4) for n in CLI_IMAGES.values())
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc, cli_counts = _counted(lambda: infer_main([
                "--config", str(cfg_path), "--image-dir", str(images),
                "--batch-size", "4", "--output-dir", str(out_dir)]),
                {"depthwise3x3": 2 * n_batches, "depthwise3x3_dilated": 3 * n_batches,
                 "upsample_argmax": n_fused})
        cli_s = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"infer CLI exited {rc}")
        names = sorted(p.stem for p in images.iterdir())
        want_files = {f"{n}_{lvl}{sfx}.png" for n in names for lvl in levels
                      for sfx in ("", "_color")}
        written = {p.name for p in out_dir.iterdir()}
        if written != want_files:
            raise AssertionError(f"CLI wrote {sorted(written)}, want {sorted(want_files)}")
        cli_agree = {lvl: [] for lvl in levels}
        for (H, W), n in CLI_IMAGES.items():
            group = [f"img{W}x{H}_{i}" for i in range(n)]
            for start in range(0, n, 4):
                chunk = group[start:start + 4]
                batch = np.stack([preprocess_image(str(images / f"{b}.png"),
                                                   cfg.transform.resize)[0] for b in chunk])
                direct = predictor.predict_array(batch, out_hw=(H, W))
                ref = predictor_xla.predict_array(batch, out_hw=(H, W))
                for j, b in enumerate(chunk):
                    for lvl in levels:
                        got = np.asarray(Image.open(out_dir / f"{b}_{lvl}.png"))
                        if not np.array_equal(got, direct[lvl][j]):
                            raise AssertionError(f"CLI {b} {lvl}: differs from predict_array")
                for lvl, v in _levels_agree(direct, ref).items():
                    cli_agree[lvl].append(v)
        cli_agree = {lvl: min(v) for lvl, v in cli_agree.items()}

    # -- the batch-4 predict_masks, by CUDA events
    batch4 = rng.integers(0, 256, (4, *size, 3), dtype=np.uint8)
    n_timed, n_warm = 10, 2
    predict_ms, predict_counts = _counted(
        lambda: _event_ms(lambda: predictor.predict_masks(batch4), n_timed, n_warm),
        {"depthwise3x3": 2 * (n_timed + n_warm), "depthwise3x3_dilated": 3 * (n_timed + n_warm),
         "upsample_argmax": n_timed + n_warm})
    predict_ms_xla = _event_ms(lambda: predictor_xla.predict_masks(batch4), n_timed, n_warm)
    with torch.inference_mode():
        if not bool(torch.isfinite(predictor.logits(batch4)).all().item()):
            raise AssertionError("non-finite logits")

    # -- sliding window and TTA, batch 1: timed runs after one warm-up run,
    # peak memory, and the masks against the library-op predictor's
    big = rng.integers(0, 256, (1, *SLIDING["hw"], 3), dtype=np.uint8)
    img = batch4[:1]
    runs = {
        "sliding": (lambda p: p.predict_sliding(big, SLIDING["window"], SLIDING["stride"]),
                    SLIDING["windows"]),
        "tta": (lambda p: p.predict_tta(img, scales=TTA_SCALES, flip=True),
                2 * len(TTA_SCALES)),
    }
    report, counts = {}, {"cli": cli_counts, "predict_masks": predict_counts}
    for what, (run, forwards) in runs.items():
        run(predictor)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n_runs = 3

        def timed():
            ms = []
            for _ in range(n_runs):
                t0 = time.perf_counter()
                out = run(predictor)  # masks on the host: the run has ended
                ms.append((time.perf_counter() - t0) * 1e3)
            return out, ms

        (masks, ms), c = _counted(timed, {"depthwise3x3": 2 * forwards * n_runs,
                                          "depthwise3x3_dilated": 3 * forwards * n_runs,
                                          "upsample_argmax": 0})
        counts[what] = c
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        agree = _levels_agree(masks, run(predictor_xla))
        report[what] = {"ms": ms, "ms_median": float(np.median(ms)), "forwards": forwards,
                        "peak_mb": peak_mb, "min_pixel_agreement_vs_library": agree,
                        "shape": list(masks["fine"].shape)}
    worst = min([*cli_agree.values()] + [v for r in report.values()
                                         for v in r["min_pixel_agreement_vs_library"].values()])
    if worst < AGREE_MIN:
        raise AssertionError(f"kernel path vs library path agreement {worst} < {AGREE_MIN}: "
                             f"CLI {cli_agree}, {report}")
    launches = {run: {k: c[k] for k in ("depthwise3x3", "depthwise3x3_dilated", "upsample_argmax")}
                for run, c in counts.items()}
    total = {k: sum(c[k] for c in counts.values()) for k in cli_counts}
    say("infer5", cli_images=sum(CLI_IMAGES.values()), cli_batches=n_batches, cli_s=cli_s,
        cli_images_per_s=sum(CLI_IMAGES.values()) / cli_s,
        cli_timing="in-process main(): model build, checkpoint load, PNG decode, predict and "
        "PNG encode of 6 masks per image",
        cli_min_pixel_agreement_vs_library=cli_agree,
        predict_b4_ms_median=float(np.median(predict_ms)), predict_b4_ms=predict_ms,
        predict_b4_library_ms_median=float(np.median(predict_ms_xla)),
        sliding=report["sliding"], tta=report["tta"],
        launches_by_run=launches,
        setup_s=round(setup_s, 2), card=device_line)
    return k5, total


# ---------------------------------------------------------------------------
# The train phase's tolerances, kernel path against library path on one
# batch with the same weights. The two paths run the same cuDNN backbone
# and differ in the head's two 3×3 depthwise convolutions (f32 sums in
# another order before the bf16 rounding, forward and both gradients) and
# in the loss (the fused kernels' f32 order; an l_f == l_coarse tie goes
# wholly to the fine channel where autograd splits it in half). A logit
# moves by about one bf16 ulp (2^-8) where a rounding flips; the loss is a
# mean over 2.1 M pixels, so it moves far less than one ulp:
LOSS_RTOL = 1e-3
# each gradient entry carries such one-ulp differences back through up to
# 50 bf16 layers; uncorrelated perturbations of ≤ 0.4 % keep each
# parameter's gradient direction well within 1 %:
GRAD_COS_MIN = 0.99
# and each parameter's gradient norm within 2 % of the library path's (5×
# that 0.4 %), so that a term whose gradient is off by a constant factor
# fails where a cosine alone would pass it:
GRAD_NORM_RTOL = 0.02
# the triplet ramp is exactly 0 in f32 for the first steps of a run; the
# comparison pass evaluates the loss mid-schedule so that the projection
# head's gradient is live on both paths
TRIPLET_LIVE_STEP = 40_000
# train4's comparison (b), the fast kernel path (rmi_precision: fast)
# against the parity kernel path on one batch: only the RMI term's Grams
# differ (bf16 views), so the loss moves by at most that term's
# fast-vs-parity tolerance times its share of the loss (λ·RMI / loss,
# measured on the batch on the parity path). The RMI term's gradient moves
# by a few 1e-3 of itself (one bf16 rounding of P and of z), which reaches
# the parameters through the same bf16 layers as the kernel-vs-library
# differences: GRAD_COS_MIN and GRAD_NORM_RTOL hold for it too.
# The train phases. Per phase: its config, the depth and image size it
# must have and what else it must select, the library path's knobs, other
# paths compared on the one batch (their knobs and launches), the pairs
# compared, and the kernel launches of one train step of the config's own
# path — depthwise forward, input gradient and weight gradient (the head's
# two sep-bottleneck convolutions) and the loss kernels (config 2: the
# fused loss forward and backward; config 3: the RMI Gram kernels #6, #7
# forward and #8 backward; config 4: their bf16-view variants #6f–#8f).
# A train step needs the ASPP's backward, so its dilated branches stay on
# cuDNN: none of the dilated forward #9 (the evaluation's batches take it).
_DW = {"depthwise3x3": 2, "depthwise3x3_dgrad": 2, "depthwise3x3_wgrad": 2,
       "depthwise3x3_dilated": 0}
_NO_FUSED = {"hiera2_fused_fwd": 0, "hiera2_fused_bwd": 0}
_NO_RMI = {"rmi_gram18": 0, "rmi_residual_gram": 0, "rmi_grad_maps": 0,
           "rmi_gram18_fast": 0, "rmi_residual_gram_fast": 0, "rmi_grad_maps_fast": 0}
_RMI_PARITY = dict(_NO_RMI, rmi_gram18=1, rmi_residual_gram=1, rmi_grad_maps=1)
_RMI_FAST = dict(_NO_RMI, rmi_gram18_fast=1, rmi_residual_gram_fast=1, rmi_grad_maps_fast=1)
TRAIN_PHASES = {
    "train": {
        "config": "example-train-hopper.yaml", "what": "config 2", "model": (50, (512, 512)),
        "selects": lambda m, t, h: (t.pallas_fused_loss, t.batch_size, h.has_super)
        == (True, 8, False),
        "library": {"pallas_fused_loss": False},
        "paths": {},
        "compare": (("kernel", "library"),),
        "launches": dict(_DW, hiera2_fused_fwd=1, hiera2_fused_bwd=1, **_NO_RMI),
    },
    "trainfiles": {
        "config": "example-train-files-hopper.yaml",
        "what": "config 2 from files (raw cache, native transforms, device flip, "
                "backbone LR scale 0.1, no decay on norm and bias, clip 1.0)",
        "model": (50, (512, 512)),
        "selects": lambda m, t, h: (
            t.pallas_fused_loss, t.batch_size, h.has_super, t.backbone_lr_scale,
            t.wd_skip_norm_bias, t.grad_clip_norm, t.num_workers)
        == (True, 8, False, 0.1, True, 1.0, 4),
        "files": True,
        "library": {"pallas_fused_loss": False},
        "paths": {},
        "compare": (("kernel", "library"),),
        "launches": dict(_DW, hiera2_fused_fwd=1, hiera2_fused_bwd=1, **_NO_RMI),
    },
    "train150": {
        "config": "example-train-150-hopper.yaml", "what": "the 150-class config",
        "model": (50, (512, 512)),
        "selects": lambda m, t, h: (t.pallas_fused_loss, t.hiera_precision, t.batch_size,
                                    h.has_super, h.total_classes)
        == (True, "parity", 8, False, 165),
        "library": {"pallas_fused_loss": False},
        "paths": {},
        "compare": (("kernel", "library"),),
        "launches": dict(_DW, hiera2_fused_fwd=1, hiera2_fused_bwd=1, **_NO_RMI),
    },
    "train3": {
        "config": "example-train-3level-hopper.yaml", "what": "config 3",
        "model": (50, (512, 512)),
        "selects": lambda m, t, h: (t.rmi_backend, t.rmi_precision, t.pallas_fused_loss,
                                    t.batch_size, h.has_super, h.total_classes)
        == ("pallas", "parity", False, 4, True, 15),
        "library": {"rmi_backend": "xla"},
        "paths": {},
        "compare": (("kernel", "library"),),
        "launches": dict(_DW, **_NO_FUSED, **_RMI_PARITY),
    },
    "train4": {
        "config": "example-train-r101-769-hopper.yaml", "what": "config 4",
        "model": (101, (769, 769)),
        "selects": lambda m, t, h: (t.rmi_backend, t.rmi_precision, t.pallas_fused_loss,
                                    t.batch_size, h.has_super, h.total_classes)
        == ("pallas", "fast", False, 2, True, 15),
        "library": {"rmi_backend": "xla"},
        "paths": {"parity": ({"rmi_precision": "parity"}, dict(_DW, **_NO_FUSED, **_RMI_PARITY))},
        # (a) parity kernels vs library ops, (b) fast kernels vs parity kernels
        "compare": (("parity", "library"), ("kernel", "parity")),
        "launches": dict(_DW, **_NO_FUSED, **_RMI_FAST),
    },
}


def _counters():
    from seghiero_torch.ops import depthwise, hiera2_fused, rmi_gram, upsample_argmax

    return {"depthwise3x3": (depthwise, "launches"),
            "depthwise3x3_dgrad": (depthwise, "dgrad_launches"),
            "depthwise3x3_wgrad": (depthwise, "wgrad_launches"),
            "depthwise3x3_dilated": (depthwise, "dilated_launches"),
            "hiera2_fused_fwd": (hiera2_fused, "fwd_launches"),
            "hiera2_fused_bwd": (hiera2_fused, "bwd_launches"),
            "rmi_gram18": (rmi_gram, "gram18_launches"),
            "rmi_residual_gram": (rmi_gram, "residual_launches"),
            "rmi_grad_maps": (rmi_gram, "grad_launches"),
            "rmi_gram18_fast": (rmi_gram, "gram18_fast_launches"),
            "rmi_residual_gram_fast": (rmi_gram, "residual_fast_launches"),
            "rmi_grad_maps_fast": (rmi_gram, "grad_fast_launches"),
            "upsample_argmax": (upsample_argmax, "launches"),
            "backward_copies": (depthwise, "backward_copies")}


def read_counts():
    return {k: getattr(mod, attr) for k, (mod, attr) in _counters().items()}


def zero_counts():
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def _grads(model, composite, cfg, batch):
    """Loss and f32 gradients of one train-mode pass (no update)."""
    from seghiero_torch.train.steps import forward_losses

    model.train()
    model.zero_grad(set_to_none=True)
    loss, _, _, _ = forward_losses(model, composite, cfg, batch, TRIPLET_LIVE_STEP)
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


def _step_times(model, composite, optimizer, cfg, batch, n_steps: int = 8):
    """Device ms of each of ``n_steps`` ``train_step`` calls on one batch
    already on the card, from CUDA events around each call."""
    import torch

    from seghiero_torch.train.steps import train_step

    events = []
    for i in range(n_steps):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        train_step(model, composite, optimizer, cfg, batch, i)
        ev[1].record()
        events.append(ev)
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events]


def _median_3_to_8(ms):
    return float(np.median(ms[2:8]))


# the trainfiles phase's data: PNG frames of Cityscapes' size, in the
# config's train and val directories
FILES_HW = (1024, 2048)
FILES_N = {"train": 64, "val": 16}


def prepare_files(cfg, weights, seed: int, data_dir: Path):
    """The data of a phase from files, in ``data_dir``: image and mask PNGs
    of the synthetic shapes at ``FILES_HW`` made from ``seed``, the made-up
    backbone in torchvision's layout (``conv1``, ``bn1``, a classifier
    ``fc``) as a ``.pth``, and the config pointed at both, whose raw caches
    the port's cache CLI then prebuilds in process. Returns that config and
    a report (the ``.pth``'s state dict under ``pth``)."""
    import copy
    import re
    from concurrent.futures import ThreadPoolExecutor

    import torch
    import yaml
    from PIL import Image

    from seghiero_torch.config import load_config
    from seghiero_torch.data import cache
    from seghiero_torch.data.synthetic import SyntheticShapesDataset

    pth = {re.sub(r"^stem_bn\.", "bn1.", re.sub(r"^stem_conv\.", "conv1.", k)): v
           for k, v in weights["backbone_state_dict"].items()}
    gen = torch.Generator().manual_seed(seed + 2)
    pth["fc.weight"] = torch.randn(1000, 2048, generator=gen) * 0.01
    pth["fc.bias"] = torch.zeros(1000)
    torch.save(pth, data_dir / "resnet50.pth")
    raw = copy.deepcopy(cfg.raw)
    raw["dataset"].update(root=str(data_dir / "data"), cache_dir=str(data_dir / "cache"))
    raw["model"]["pretrained"] = str(data_dir / "resnet50.pth")
    raw["output"] = dict(raw.get("output") or {}, checkpoint_dir=cfg.output.checkpoint_dir)
    path = data_dir / "config.yaml"
    path.write_text(yaml.safe_dump(raw))
    cfg = load_config(str(path))

    t0 = time.perf_counter()
    for split, n in FILES_N.items():
        ds = SyntheticShapesDataset(cfg, split=split, seed=seed, size=n, image_hw=FILES_HW)
        img_dir, msk_dir = Path(cfg.dataset.image_dir(split)), Path(cfg.dataset.mask_dir(split))
        img_dir.mkdir(parents=True)
        msk_dir.mkdir(parents=True)

        def write(i, ds=ds, img_dir=img_dir, msk_dir=msk_dir):
            s = ds[i]
            Image.fromarray(s["image"]).save(img_dir / f"{i:04d}.png", compress_level=1)
            Image.fromarray(s["fine"].astype(np.uint8)).save(msk_dir / f"{i:04d}.png",
                                                             compress_level=1)

        with ThreadPoolExecutor(8) as pool:
            list(pool.map(write, range(n)))
    write_s = time.perf_counter() - t0
    png_mb = sum(f.stat().st_size for f in (data_dir / "data").rglob("*.png")) / 2**20

    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        if cache.main(["--config", str(path)]) != 0:
            raise AssertionError(f"the cache CLI failed:\n{log.getvalue()}")
    build_s = time.perf_counter() - t0
    cache_mb = sum(f.stat().st_size for f in (data_dir / "cache").rglob("*") if f.is_file())
    return cfg, {"pngs": FILES_N, "png_hw": FILES_HW, "png_mb": png_mb,
                 "png_write_s": round(write_s, 2), "cache_build_s": build_s,
                 "cache_mb": cache_mb / 2**20,
                 "cache_cli": log.getvalue().strip().splitlines(), "pth": pth}


def check_files(trainer, cfg, pth):
    """A phase from files, before its own checks: the backbone the
    ``Trainer`` built holds the ``.pth``'s tensors; the first train batch
    from the raw cache — through the loader, and through ``get_batch`` in
    its uint8 storage — equals the uncached dataset's bit for bit; the
    native transforms equal their plain versions on the phase's images."""
    import torch

    from seghiero_torch.data import native
    from seghiero_torch.data.dataset import HieroDataset, read_pair
    from seghiero_torch.data.pipeline import BatchLoader
    from seghiero_torch.models.convert import import_torchvision_backbone

    if "conv1.weight" not in pth or "fc.weight" not in pth:
        raise AssertionError("the .pth is not in torchvision's layout")
    want = import_torchvision_backbone(pth, cfg.model.depth)
    backbone = trainer.model.backbone.state_dict()
    bad = [k for k in backbone if not torch.equal(backbone[k].cpu(), want[k])]
    if bad or set(backbone) != set(want):
        raise AssertionError(f"backbone differs from the .pth at {bad[:5]}")

    t = cfg.training
    loader = trainer.train_loader
    loader.set_epoch(0)
    idx = next(loader._batch_indices())
    uncached = BatchLoader(HieroDataset(cfg, "train", seed=t.seed, include_levels=False),
                           t.batch_size, shuffle=True, seed=t.seed, num_workers=t.num_workers)
    uncached.set_epoch(0)
    want = uncached.make_batch(idx)
    for what, got in (("loader", loader.make_batch(idx)),
                      ("get_batch", trainer.train_ds.get_batch(idx))):
        if set(got) != set(want) or any(
                not np.array_equal(got[k], want[k]) for k in want):
            raise AssertionError(f"the cached first batch ({what}) differs from the uncached")
    if trainer.train_ds.get_batch(idx)["fine"].dtype != np.uint8:
        raise AssertionError("the cache's labels are not stored as uint8")

    img, fine = read_pair(trainer.train_ds.base.img_paths[0],
                          trainer.train_ds.base.msk_paths[0])
    img, fine = np.asarray(img), fine.astype(np.int32)
    base = np.asarray(trainer.train_ds.images[0])
    lut = cfg.hierarchy.fine_to_coarse
    ops = {
        "resize_bilinear_u8": lambda m: m.resize_bilinear_u8(img, cfg.transform.resize),
        "resize_bilinear_u8 up": lambda m: m.resize_bilinear_u8(base, (701, 701)),
        "resize_bilinear_u8 down": lambda m: m.resize_bilinear_u8(base, (301, 301)),
        "resize_nearest_i32": lambda m: m.resize_nearest_i32(fine, cfg.transform.resize),
        "hflip_u8": lambda m: m.hflip_u8(base),
        "hflip_i32": lambda m: m.hflip_i32(fine),
        "lut_remap_i32": lambda m: m.lut_remap_i32(fine, lut),
    }
    plain = types.SimpleNamespace(**{
        k: getattr(native, k + "_plain") for k in
        ("resize_bilinear_u8", "resize_nearest_i32", "hflip_u8", "hflip_i32", "lut_remap_i32")})
    timings = {}
    for what, op in ops.items():
        t0 = time.perf_counter()
        a = op(native)
        t1 = time.perf_counter()
        b = op(plain)
        t2 = time.perf_counter()
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"native {what} differs from its plain version")
        timings[what] = {"native_ms": (t1 - t0) * 1e3, "plain_ms": (t2 - t1) * 1e3}
    return {"first_batch_cached_equals_uncached": True, "backbone_tensors_equal_pth": len(backbone),
            "native_equals_plain_ms": timings}


def loader_ms_per_batch(loader) -> float:
    """Host ms per batch of one pass over ``loader`` with nothing else to
    do (epoch 1's augmentation; the copy to the card included)."""
    import torch

    loader.set_epoch(1)
    n = 0
    t0 = time.perf_counter()
    for _ in loader:
        n += 1
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / max(n, 1)
    loader.set_epoch(0)
    return ms


def phase_train(name: str, seed: int, device_line: str):
    """One train phase of ``TRAIN_PHASES``; returns the launch counts of
    its ``fit`` run, loop images/s and loader ms per batch. A phase from
    files first writes its data and backbone weights (``prepare_files``)
    and checks them (``check_files``)."""
    import shutil

    import torch

    from seghiero_torch.config import load_config
    from seghiero_torch.models.convert import load_reference_checkpoint
    from seghiero_torch.train.trainer import Trainer

    torch.cuda.empty_cache()  # what the previous phase left cached
    spec = TRAIN_PHASES[name]
    cfg = load_config(str(ROOT / "configs" / spec["config"]))
    m, t = cfg.model, cfg.training
    depth, hw = spec["model"]
    if ((m.depth, m.dtype, m.depthwise_backend, tuple(cfg.transform.resize))
            != (depth, "bfloat16", "pallas", hw) or not spec["selects"](m, t, cfg.hierarchy)):
        raise AssertionError(f"the {name} config must be {spec['what']} with its kernels on")
    ckpt_dir = ROOT / "checkpoints" / f"chip-smoke-{name}"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg = dataclasses.replace(cfg, output=dataclasses.replace(
        cfg.output, checkpoint_dir=str(ckpt_dir)))
    t0 = time.perf_counter()
    weights = made_up_checkpoint(cfg, seed)
    with contextlib.ExitStack() as stack:
        files = None
        if spec.get("files"):
            data_dir = Path(stack.enter_context(tempfile.TemporaryDirectory()))
            cfg, files = prepare_files(cfg, weights, seed, data_dir)
        trainer = Trainer(cfg, device="cuda")
        if files is not None:
            files.update(check_files(trainer, cfg, files.pop("pth")))
        load_reference_checkpoint(trainer.model, weights)
        setup_s = time.perf_counter() - t0
        return _train_checks(name, spec, cfg, trainer, weights, setup_s, files, device_line,
                             ckpt_dir)


def _train_checks(name, spec, cfg, trainer, weights, setup_s, files, device_line, ckpt_dir):
    """The checks and measurements every train phase runs, on its
    ``Trainer`` with the made-up ``weights`` loaded."""
    import copy
    import shutil

    import torch

    from seghiero_torch.losses import fast as loss_fast
    from seghiero_torch.models.convert import load_reference_checkpoint
    from seghiero_torch.models.segmenter import build_model
    from seghiero_torch.train import loop
    from seghiero_torch.train.optim import make_optimizer
    from seghiero_torch.train.steps import make_composite_loss
    from seghiero_torch.train.trainer import Trainer

    step_launches = spec["launches"]
    m, t = cfg.model, cfg.training

    # -- the paths compared on one batch with the same weights: the
    # config's own ("kernel"), the library ops ("library") and the
    # phase's other kernel paths (a copy of the model, another loss)
    cfg_lib = dataclasses.replace(
        cfg, model=dataclasses.replace(m, depthwise_backend="xla"),
        training=dataclasses.replace(t, **spec["library"]))
    lib_model = load_reference_checkpoint(build_model(cfg_lib), weights).to(
        "cuda", memory_format=torch.channels_last)
    ker_model = copy.deepcopy(trainer.model)
    paths = {"kernel": (ker_model, trainer.composite, cfg, step_launches),
             "library": (lib_model, make_composite_loss(cfg_lib), cfg_lib, None)}
    for path, (knobs, launches) in spec["paths"].items():
        c = dataclasses.replace(cfg, training=dataclasses.replace(t, **knobs))
        paths[path] = (ker_model, make_composite_loss(c), c, launches)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             trainer.train_loader.make_batch(np.arange(t.batch_size)).items()}
    losses_1, grads_1, rmi_share = {}, {}, {}
    real_rmi = loss_fast.rmi_lower_bound_cmajor
    for path, (model, composite, c, launches) in paths.items():
        rmi_seen = []

        def recording_rmi(*a, **kw):  # the RMI term's value, for its share
            v = real_rmi(*a, **kw)
            rmi_seen.append(float(v.detach()))
            return v

        zero_counts()
        loss_fast.rmi_lower_bound_cmajor = recording_rmi
        try:
            losses_1[path], grads_1[path] = _grads(model, composite, c, batch)
        finally:
            loss_fast.rmi_lower_bound_cmajor = real_rmi
        counts = read_counts()
        if launches is not None and any(counts[k] != n for k, n in launches.items()):
            raise AssertionError(f"{path} comparison pass launches {counts}, want {launches}")
        if rmi_seen:
            rmi_share[path] = abs(c.training.fine_weight * rmi_seen[0] / losses_1[path])
        # the copy of the model is shared: keep this path's gradients
        grads_1[path] = {n: g.clone() for n, g in grads_1[path].items() if g is not None}
    bad = [n for n, p in ker_model.named_parameters()
           if n not in grads_1["kernel"] or not bool(torch.isfinite(grads_1["kernel"][n]).all())
           or not bool(grads_1["kernel"][n].abs().max() > 0)]
    if bad:
        raise AssertionError(f"kernel path: no finite non-zero gradient for {bad}")
    failed = []
    for a, b in spec["compare"]:
        ga, gb = grads_1[a], grads_1[b]
        cos = {n: float(torch.nn.functional.cosine_similarity(
            ga[n].flatten().double(), gb[n].flatten().double(), dim=0)) for n in ga}
        norm_dev = {n: abs(float(ga[n].double().norm() / gb[n].double().norm()) - 1.0)
                    for n in ga}
        worst = sorted(cos.items(), key=lambda kv: kv[1])[:5]
        worst_norm = sorted(norm_dev.items(), key=lambda kv: -kv[1])[:5]
        loss_rel = abs(losses_1[a] - losses_1[b]) / abs(losses_1[b])
        # kernel paths against each other differ in the RMI term's precision only
        loss_rtol = (RMI_FAST_VALUE_RTOL * rmi_share[b] if b != "library" else LOSS_RTOL)
        say(name, check=f"{a} path vs {b} path, one batch, same weights",
            loss=losses_1[a], loss_ref=losses_1[b], loss_rel_diff=loss_rel, loss_rtol=loss_rtol,
            rmi_share_of_loss=rmi_share.get(b), grad_cos_min=worst[0][1],
            grad_cos_floor=GRAD_COS_MIN, worst_params=worst,
            grad_norm_ratio_max_dev=worst_norm[0][1], grad_norm_rtol=GRAD_NORM_RTOL,
            worst_norm_params=worst_norm, params=len(cos), setup_s=round(setup_s, 2))
        if (loss_rel > loss_rtol or worst[0][1] < GRAD_COS_MIN
                or not worst_norm[0][1] <= GRAD_NORM_RTOL):
            failed.append(f"{a} vs {b}")
    if failed:
        raise AssertionError(f"paths disagree beyond the tolerances: {failed}")
    del grads_1

    # -- device step time of every path on the batch already on the card,
    # in the order kernel, others, library, library, others, kernel
    opts = {p: make_optimizer(c.training, mdl)
            for p, (mdl, _, c, _) in paths.items()}
    times = {p: {"step_ms_median_3_8": [], "peak_mb_above_resident": 0.0} for p in paths}
    order = ["kernel", *spec["paths"], "library"]
    for path in order + order[::-1]:
        model, composite, c, _ = paths[path]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = _step_times(model, composite, opts[path], c, batch)
        times[path]["step_ms_median_3_8"].append(_median_3_to_8(ms))
        times[path]["peak_mb_above_resident"] = max(
            times[path]["peak_mb_above_resident"],
            (torch.cuda.max_memory_allocated() - base) / 2**20)
    loader_ms = loader_ms_per_batch(trainer.train_loader)
    del ker_model, lib_model, paths, opts
    torch.cuda.empty_cache()

    # -- the main path: Trainer.fit() — every step through the kernels
    per_step, losses, events, grad_report = [], [], [], {}
    real_step = loop.train_step

    def checked_step(model, composite, optimizer, cfg_, batch_, step, epoch=0, scheduler=None):
        before = read_counts()
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = real_step(model, composite, optimizer, cfg_, batch_, step, epoch, scheduler)
        ev[1].record()
        after = read_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        events.append(ev)
        losses.append(out["loss"])
        if len(per_step) == 1:  # step 1: every gradient finite; non-zero
            # except the projection head's, which the triplet ramp (0 at
            # step 0) multiplies by 0
            grad_report["non_finite"] = [
                n for n, p in model.named_parameters()
                if p.grad is None or not bool(torch.isfinite(p.grad).all())]
            grad_report["zero"] = [n for n, p in model.named_parameters()
                                   if p.grad is not None and not bool(p.grad.abs().max() > 0)]
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    loop.train_step = checked_step
    try:
        t_fit = time.perf_counter()
        history = trainer.fit()
        fit_s = time.perf_counter() - t_fit
    finally:
        loop.train_step = real_step
    fit_counts = read_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    n_steps = len(per_step)
    if n_steps != len(trainer.train_loader) or n_steps < 8:
        raise AssertionError(f"{n_steps} train steps ran")
    for i, c in enumerate(per_step):
        if any(c[k] != n for k, n in step_launches.items()):
            raise AssertionError(f"step {i + 1} launches {c}, want {step_launches}")
    if grad_report["non_finite"] or any(
            not n.startswith("aspp_head.proj_head.") for n in grad_report["zero"]):
        raise AssertionError(f"step 1 gradients: {grad_report}")
    step_losses = [float(x) for x in losses]
    if not all(np.isfinite(step_losses)):
        raise AssertionError(f"non-finite step loss: {step_losses}")
    fit_ms = [a.elapsed_time(b) for a, b in events]
    rec = history[-1]
    levels = ("fine", "coarse", "super") if cfg.hierarchy.has_super else ("fine", "coarse")
    if not (np.isfinite(rec["val_loss"])
            and all(0.0 <= rec[f"val_{lvl}_miou"] <= 1.0 for lvl in levels)):
        raise AssertionError(f"evaluation: {rec}")

    # -- checkpoint round trip: a fresh Trainer resumes, same eval loss bits
    fresh = Trainer(cfg, device="cuda", verbose=False, resume=True)
    if fresh.step != trainer.step or fresh.start_epoch != 1:
        raise AssertionError(f"resumed at step {fresh.step}, epoch {fresh.start_epoch}")
    val_again = fresh.evaluate()["loss"]
    if val_again != rec["val_loss"]:
        raise AssertionError(f"eval loss after restore {val_again!r} != {rec['val_loss']!r}")
    del fresh
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    say(name, steps=n_steps, launches_per_step=per_step[0], launches_total=fit_counts,
        backward_copies_per_step=per_step[0]["backward_copies"],
        step_losses=step_losses, zero_grad_params_step1=grad_report["zero"],
        val=rec, eval_loss_after_restore=val_again,
        device_step_ms_median_3_8={p: v["step_ms_median_3_8"] for p, v in times.items()},
        peak_mb_above_resident={k: v["peak_mb_above_resident"] for k, v in times.items()},
        fit_step_ms=fit_ms, fit_step_ms_median_3_8=_median_3_to_8(fit_ms),
        fit_images_per_s=rec["train_images_per_sec"], fit_train_seconds=rec["train_seconds"],
        fit_s=round(fit_s, 2), fit_max_memory_allocated_mb=peak_mb,
        loader_ms_per_batch=loader_ms,
        **({"files": files} if files else {}), card=device_line)
    return {"counts": fit_counts, "fit_images_per_s": rec["train_images_per_sec"],
            "loader_ms_per_batch": loader_ms}


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this run needs the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import seghiero_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    name, count, smi, sm_mhz = phase_device()
    phase_build()
    kernels = phase_kernels(SEED)
    kernels.update(phase_train_kernels(SEED, sm_mhz))
    t_kernels = time.perf_counter()
    paths = {"serve": phase_serve(SEED, N_REQUESTS, smi)}
    t_serve = time.perf_counter()
    kernels["config5"], paths["infer5"] = phase_infer5(SEED, smi)
    t_infer5 = time.perf_counter()
    train_s, reports = {}, {}
    for phase in TRAIN_PHASES:
        t_phase = time.perf_counter()
        reports[phase] = phase_train(phase, SEED, smi)
        paths[phase] = reports[phase]["counts"]
        train_s[phase] = round(time.perf_counter() - t_phase, 1)
    # config 2 from files against config 2 on synthetic batches made in memory
    say("trainfiles vs train", **{k: {p: reports[p][k] for p in ("train", "trainfiles")} for k in
                                  ("fit_images_per_s", "loader_ms_per_batch")}, card=smi)
    say("elapsed", seconds_to_kernels_end=round(t_kernels - t_start, 1),
        serve_s=round(t_serve - t_kernels, 1), infer5_s=round(t_infer5 - t_serve, 1),
        train_s=train_s,
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
        by_path = {p: c[kname] for p, c in paths.items() if c.get(kname)}
        if sum(by_path.values()) <= 0:
            raise AssertionError(f"{kname} was not launched on its path")
        if kname.endswith("_fast") and not by_path.get("train4"):
            raise AssertionError(f"{kname} was not launched on train4")
        if kname in kernels["config5"] and not by_path.get("infer5"):
            raise AssertionError(f"{kname} was not launched on infer5")
        line.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            **({"instantiation": "bf16 views (training.rmi_precision: fast)",
                "f32_twin_ms": k["f32_twin_ms"]} if kname.endswith("_fast") else {}),
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "shapes": k["shapes"],
            **{x: k[x] for x in ("graph_ms", "library_graph_ms", "unfused_ms", "unfused_what",
                                 "by_dilation",
                                 "kernel_path_ms", "kernel_over_library", "cudnn_two_call_ms",
                                 "kernel_over_cudnn_two_call") if x in k},
            # the depthwise kernels also at config 4's shapes (train4's path),
            # #1 and #3 at config 5's (infer5's), the fused loss at the
            # 150-class config's (train150's)
            **({"config4": kernels["config4"][kname]} if kname in kernels["config4"] else {}),
            **({"config5": kernels["config5"][kname]} if kname in kernels["config5"] else {}),
            # the decode also in bf16, the dtype of the serving model's logits
            **({"bfloat16": k["bfloat16"]} if "bfloat16" in k else {}),
            **({"config150": kernels["config150"][kname]}
               if kname in kernels["config150"] else {}),
        })
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
