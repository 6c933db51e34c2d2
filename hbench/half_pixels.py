"""The planted fault of half the pixels, read at a cell's full size: the
reference's steps with the bottom half of every label map ignored (255)
against its steps on the whole maps, on the batches a run of the cell
keeps for its check, compared as the check compares the program.

It stands in for half the batch where a batch holds one image, and gives
the upper reading of ``limits/<cell>.json``'s ``loss_gap_median``
(``vitl16-3level.train-1024``).

    python hbench/half_pixels.py --workload <cell> --seeds 1,2,3 [--device cuda]

One JSON line a seed: the fault's numbers, and the reference's peak
device memory over its steps on the whole maps.
"""

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("loss_gap", "loss_gap_median", "logits_gap", "grad_gap", "change_gap")


def read(bench, cell: str, seed: int, device: str, overrides=None):
    """(the fault's numbers, the reference's peak bytes on the card or 0)."""
    import torch

    from hbench.core import harness, trainlib
    from hbench.reference import compare

    ctx = harness.context(bench, cell, seed, device, overrides=overrides)
    drv = bench.driver(ctx.traffic["driver"]).Driver(ctx)
    drv.feed = drv.make_feed()
    kept = []
    for _ in range(trainlib.PRE_STEPS):
        b = drv.next_batch()
        kept.append({k: b[k].clone() for k in ("image", "fine")})
    drv.close_feed()
    half = []
    for b in kept:
        fine = b["fine"].clone()
        fine[:, fine.shape[1] // 2:] = 255
        half.append(dict(b, fine=fine))
    sd = drv._weights()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    with trainlib.full_fp32():
        whole = drv._reference(sd, kept)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        numbers = compare.train_numbers(drv._reference(sd, half), whole)
    del drv, sd, whole, kept, half
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return {k: numbers[k] for k in KEYS}, peak


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from hbench.core import spec

    bench = spec.Bench(ROOT / "BENCHMARK.json")
    for s in (int(x) for x in args.seeds.split(",")):
        numbers, peak = read(bench, args.workload, s, args.device)
        print(json.dumps({"workload": args.workload, "seed": s, "half_pixels": numbers,
                          "reference_peak_bytes": peak}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
