"""Kernels #7 (the f32 RMI residual Gram) and #3 (the serving decode) of
other source trees, timed in turns against this checkout's on one card.

    python -m seghiero_torch.ops.kernel_turns DIR[=ROWSxCOLS] [DIR ...]
        [--entry NAME=SUBSTRING:OP:PIXELS ...]

Run from the root of a checkout, on a machine with the card. Each DIR is
another checkout or a copy with edited sources (its
``seghiero_torch/csrc``); ``=ROWSxCOLS`` gives the output rows × columns
that one partial row of its #7 sums, where they differ from this
checkout's tiles (``32x128`` for a tree whose #7 is
``residual_partial_kernel``). Each tree's ``rmi_gram.cu`` and
``upsample_argmax.cu`` are built with the port's ``nvcc`` flags and
called through their C entries: #7 on config 3's and config 4's maps
(``chip_smoke.py``'s inputs), within 1e-5 of ``yb·ybᵀ`` of the plain
version in f64 and the same bits twice; #3 on the serving decode's
logits in f32 and bf16, equal to the plain version. A DIR whose name
starts with "probe" is timed unchecked (an edit that breaks the result to
isolate a cost). Each is timed in turns (the DIRs, this, this, the DIRs
reversed) by CUDA events and by CUDA-graph replay, and the SASS of its
#7 and #3 counted (``sass_counts``; ``--entry`` adds a kernel to look for,
e.g. ``residual_partial_kernel<false>=residual_partial_kernelILb0E:FFMA:32``).

Prints the card's ``nvidia-smi`` line, a line per tree and kernel, and
last one JSON object ``{"turns": ...}``. It compares versions; the port's
check on the card is ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _library(csrc: Path, out: Path):
    """``nvcc`` of ``csrc``'s RMI and decode kernels into ``out/lib.so``,
    with the port's flags; returns (path, process)."""
    from seghiero_torch.ops import _build

    out.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS[:-1], f"-I{csrc}", "-shared",
           str(csrc / "rmi_gram.cu"), str(csrc / "upsample_argmax.cu"), "-o", str(out / "lib.so")]
    return out / "lib.so", subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)


def _tree(arg: str, tile):
    """(name, csrc, (rows, cols) of one #7 partial row) of ``DIR[=ROWSxCOLS]``."""
    path, _, geometry = arg.partition("=")
    if geometry:
        tile = tuple(int(v) for v in geometry.lower().split("x"))
    return Path(path).name, Path(path) / "seghiero_torch" / "csrc", tile


def _entry(arg: str):
    """``NAME=SUBSTRING:OP:PIXELS`` → (name, a ``sass_counts`` entry)."""
    name, _, spec = arg.partition("=")
    sub, op, pixels = spec.split(":")
    return name, (sub, op, int(pixels) if pixels else None)


def turns(trees, entries, smoke):
    """The turns of ``trees`` (name → (csrc, #7 tile)), this checkout last;
    ``smoke`` is ``chip_smoke``, whose timing helpers and inputs it uses."""
    import torch

    from seghiero_torch.ops import _build
    from seghiero_torch.ops import rmi_gram as rg
    from seghiero_torch.ops import sass_counts as sc
    from seghiero_torch.ops.upsample_argmax import upsample_argmax_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    builds = {k: _library(c, ROOT / "seghiero_torch" / "build" / "turns" / k)
              for k, (c, _) in trees.items()}
    kernels = {**sc.KERNELS, **entries}
    shown = {"residual_f32_kernel", "upsample_argmax_kernel<float>",
             "upsample_argmax_kernel<bf16>", *entries}
    libs = {}
    for k, (so, proc) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {k}:\n{log[-3000:]}")
        so.with_suffix(".log").write_text(log)
        libs[k] = ctypes.CDLL(str(so))
        for fn in ("seghiero_rmi_residual", "seghiero_upsample_argmax"):
            getattr(libs[k], fn).argtypes = _build.SIGNATURES[fn]
        for name, c in sc.sass_counts(str(so), kernels).items():
            if name in shown:
                smoke.say("turns", tree=k, kernel=name, **c)
    order = [k for k in trees if k != "this"] + ["this"]
    order += order[::-1]

    def stream():  # the current stream: a CUDA graph's while one is captured
        return torch.cuda.current_stream().cuda_stream

    def timed(fns, checked):
        out = {k: {"ms": [], "graph_ms": [], **checked[k]} for k in fns}
        for k in order:
            out[k]["ms"].append(smoke.time_ms(fns[k]))
            out[k]["graph_ms"].append(smoke.time_ms_graph(fns[k]))
        return out

    results = {}
    for (B, C, H, W), seed in (((4, 15, 512, 512), smoke.SEED + 2),
                               ((2, 15, 769, 769), smoke.SEED + 3)):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        BC, n = B * C, (H - 2) * (W - 2)
        oh_map, pr_map = smoke._rmi_maps(gen, B, C, H, W)
        la, pr = oh_map.reshape(BC, H, W), pr_map.reshape(BC, H, W)
        w = rg._solve_w(rg.gram18(la, pr), n)
        want = rg.residual_gram_plain(la.double(), pr.double(), w.double())
        yb = rg._views(la.double()) + w.double().abs().mT @ rg._views(pr.double())
        mag = yb @ yb.mT
        del yb
        fns, checked = {}, {}
        for k, (_, (th, tw)) in trees.items():
            nblk = -(-(W - 2) // tw) * -(-(H - 2) // th)
            partial = torch.empty((BC, nblk, 45), device="cuda")
            a = torch.empty((BC, 9, 9), device="cuda")

            def f(lib=libs[k], nblk=nblk, partial=partial, a=a):
                err = lib.seghiero_rmi_residual(la.data_ptr(), pr.data_ptr(), w.data_ptr(),
                                                partial.data_ptr(), a.data_ptr(), BC, H, W,
                                                nblk, 0, 0, stream())
                if err:
                    raise RuntimeError(f"seghiero_rmi_residual returned {err}")
                return a

            got = f().clone()
            rel = ((got.double() - want).abs() / mag).max().item()
            same = torch.equal(got, f())
            if not k.startswith("probe") and not (rel <= 1e-5 and same):
                raise AssertionError(f"#7 of {k}: max |Δ|/mag = {rel}, same bits {same}")
            fns[k], checked[k] = f, {"max_rel_err_of_mag": rel, "same_bits": same}
        results[f"rmi_residual_gram {BC}x{H}x{W}"] = timed(fns, checked)
        del la, pr, oh_map, pr_map, want, mag, fns
        torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    B, C, h, w = 8, 13, 128, 128
    lo32 = torch.randn((B, C, h, w), generator=gen, device="cuda")
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        lo = lo32.to(dtype)
        want = upsample_argmax_plain(lo, [(0, 9), (9, 13)])
        fns, checked = {}, {}
        for k in trees:
            outs = [torch.empty((B, 4 * h, 4 * w), dtype=torch.int32, device="cuda")
                    for _ in range(2)]

            def f(lib=libs[k], outs=outs):
                err = lib.seghiero_upsample_argmax(lo.data_ptr(), B, C, h, w, code, 2, 0, 9, 9,
                                                   13, 0, 0, outs[0].data_ptr(),
                                                   outs[1].data_ptr(), None, 0, stream())
                if err:
                    raise RuntimeError(f"seghiero_upsample_argmax returned {err}")
                return outs

            exact = all(torch.equal(o, r) for o, r in zip(f(), want))
            if not k.startswith("probe") and not exact:
                raise AssertionError(f"#3 of {k} ({dtype}) differs from the plain version")
            fns[k], checked[k] = f, {"exact": exact}
        results[f"upsample_argmax {str(dtype).replace('torch.', '')}"] = timed(fns, checked)
    for what, by_tree in results.items():
        for k, r in by_tree.items():
            smoke.say("turns", what=what, tree=k, **r)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("dirs", nargs="+", metavar="DIR[=ROWSxCOLS]",
                   help="another source tree, and the #7 partial row's output rows × "
                   "columns where they differ from this checkout's tiles")
    p.add_argument("--entry", action="append", default=[], metavar="NAME=SUBSTRING:OP:PIXELS",
                   help="another kernel for sass_counts to look for in the trees")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device is visible; this run needs the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke

    from seghiero_torch.ops import rmi_gram as rg

    tile = (rg.RES_TILE_H, rg.RES_TILE_W)
    trees = {}
    for arg in args.dirs:
        name, csrc, t = _tree(arg, tile)
        trees[name] = (csrc, t)
    trees["this"] = (ROOT / "seghiero_torch" / "csrc", tile)
    smi = smoke.phase_device()[2]
    results = turns(trees, dict(map(_entry, args.entry)), smoke)
    print(smi, flush=True)
    print(json.dumps({"turns": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
