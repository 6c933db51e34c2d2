#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``seghiero_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit (an H100: the kernels are built for sm_90a). Phases, each
printed as one line, any failure exits non-zero:

1. device  — the card's name, the device count, and what ``nvidia-smi``
   reports as its name and power limit;
2. build   — ``nvcc`` builds every kernel of the serving path from
   ``seghiero_torch/csrc`` (seconds, and ``-Xptxas -v``'s registers and
   spills per kernel);
3. kernels — each kernel against its plain PyTorch version at the shapes
   serving gives it (TF32 off; bit-exact), then timed with CUDA events
   against the plain version, the PyTorch library call computing the same
   function, and the least time the card could take;
4. serve   — ``configs/example-serving-hopper.yaml`` at full width with
   weights made from a fixed seed: the port's ``ServingModel`` +
   ``make_server`` answer two bursts of concurrent 512×512 requests on a
   local port; each response must equal the predictor called directly on
   the same batch, the library-op predictor (both backends ``xla``) must
   agree on ≥99.5% of pixels per level, and each kernel's launch counter
   must show the serving run went through it.

Then one JSON line ``{"kernels": [...]}``, the ``nvidia-smi`` name/power
line, and as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
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


def bound(nbytes: int, flops: int):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
def phase_device():
    import torch

    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    say("device", name=name, count=count, nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda)
    return name, count, smi


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


def phase_kernels(seed: int):
    import torch
    import torch.nn.functional as F

    from seghiero_torch.ops.depthwise import depthwise3x3, depthwise3x3_plain
    from seghiero_torch.ops.upsample_argmax import upsample_argmax, upsample_argmax_plain

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    results = {}

    # depthwise 3×3 at the two sep-bottleneck shapes of one serving batch
    dw = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
          "max_abs_err": 0.0, "shapes": []}
    for shape in ((8, 128, 128, 560), (8, 128, 128, 512)):
        C = shape[-1]
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        k9 = (torch.randn((9, C), generator=gen, device=dev) * 0.3).to(torch.bfloat16)
        got, want = depthwise3x3(x, k9), depthwise3x3_plain(x, k9)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if err != 0.0:  # stated tolerance: bit-exact (same f32 order, no FMA)
            raise AssertionError(f"depthwise3x3 {shape}: max |kernel − plain| = {err}")
        x_cl = x.permute(0, 3, 1, 2)  # channels_last NCHW view, no copy
        w = k9.t().reshape(C, 1, 3, 3).contiguous()
        lib_err = (F.conv2d(x_cl, w, padding=1, groups=C).permute(0, 2, 3, 1).float()
                   - got.float()).abs().max().item()
        t = {
            "ms": time_ms(lambda: depthwise3x3(x, k9)),
            "plain_ms": time_ms(lambda: depthwise3x3_plain(x, k9), iters=5),
            "library_ms": time_ms(lambda: F.conv2d(x_cl, w, padding=1, groups=C)),
        }
        nbytes = x.nbytes + k9.nbytes + got.nbytes
        b_ms, b_by = bound(nbytes, 2 * 9 * x.numel())
        say("kernels", kernel="depthwise3x3", shape=list(shape), dtype="bfloat16",
            max_abs_err=err, library_max_abs_diff=lib_err, bytes=nbytes,
            bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / t["ms"], **t)
        for key in ("ms", "plain_ms", "library_ms"):
            dw[key] += t[key]
        dw["bound_ms"] += b_ms
        dw["max_abs_err"] = max(dw["max_abs_err"], err)
        dw["shapes"].append(list(shape))
        dw["bound_by"] = b_by
    results["depthwise3x3"] = dw

    # fused 4× upsample + per-level argmax at the serving decode shape
    B, C, h, w = 8, 13, 128, 128
    slices = [(0, 9), (9, 13)]
    lo = torch.randn((B, C, h, w), generator=gen, device=dev)
    got, want = upsample_argmax(lo, slices), upsample_argmax_plain(lo, slices)
    torch.cuda.synchronize()
    mism = sum(int((g != r).sum().item()) for g, r in zip(got, want))
    err = max(int((g - r).abs().max().item()) for g, r in zip(got, want))
    if mism:  # stated tolerance: exact
        raise AssertionError(f"upsample_argmax: {mism} pixels differ from the plain version")

    def library_decode():
        up = F.interpolate(lo, size=(4 * h, 4 * w), mode="bilinear", align_corners=False)
        return [up[:, a:b].argmax(dim=1).to(torch.int32) for a, b in slices]

    lib_agree = min(float((g == r).float().mean().item())
                    for g, r in zip(got, library_decode()))
    t = {
        "ms": time_ms(lambda: upsample_argmax(lo, slices)),
        "plain_ms": time_ms(lambda: upsample_argmax_plain(lo, slices), iters=5),
        "library_ms": time_ms(library_decode),
    }
    nbytes = lo.nbytes + sum(o.nbytes for o in got)
    # per output pixel and channel: 6 multiplies, 3 adds, 1 compare
    b_ms, b_by = bound(nbytes, 10 * B * 16 * h * w * C)
    say("kernels", kernel="upsample_argmax", shape=[B, C, h, w], dtype="float32",
        levels=slices, max_abs_err=err, library_pixel_agreement=lib_agree, bytes=nbytes,
        bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / t["ms"], **t)
    results["upsample_argmax"] = dict(t, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                                      shapes=[[B, C, h, w]])
    return results


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


def phase_serve(seed: int, n_requests: int, device_line: str, profile_dir):
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
    if launches["depthwise3x3"] != 2 * n_batches or launches["upsample_argmax"] != n_batches:
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
    if profile_dir:
        profile(predictor, images[:8], Path(profile_dir))
    return launches


def profile(predictor, images, out_dir: Path) -> None:
    """torch.profiler over a few batch-8 predictions: device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    out_dir.mkdir(parents=True, exist_ok=True)
    for _ in range(2):
        predictor.predict_masks(images)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            predictor.predict_masks(images)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    (out_dir / "serve_b8_profile.txt").write_text(table)
    prof.export_chrome_trace(str(out_dir / "serve_b8_trace.json"))
    print("[profile] " + "\n[profile] ".join(table.splitlines()[:25]), flush=True)


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--profile", type=str, default=None,
                   help="also write a torch.profiler table and trace of batch-8 "
                   "predictions into this directory")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this run needs the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import seghiero_torch  # noqa: F401  (fails outside a checkout of the repo)

    name, count, smi = phase_device()
    phase_build()
    kernels = phase_kernels(SEED)
    launches = phase_serve(SEED, N_REQUESTS, smi, args.profile)
    sources = {
        "depthwise3x3": ("seghiero_torch/csrc/depthwise3x3.cu",
                         "seghiero_tpu/ops/pallas/depthwise.py:221"),
        "upsample_argmax": ("seghiero_torch/csrc/upsample_argmax.cu",
                            "seghiero_tpu/ops/pallas/upsample_argmax.py:153"),
    }
    line = []
    for kname, (src, replaces) in sources.items():
        k = kernels[kname]
        if launches[kname] <= 0:
            raise AssertionError(f"{kname} was not launched on the serving path")
        line.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "shapes": k["shapes"],
        })
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
