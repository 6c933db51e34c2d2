"""The readings a cell's correctness limits are set from, in one process on
the card: the program's sound runs over many seeds (the lower reading),
and on some of them the control and the faults read against the same
reference (the upper reading): the reference in fp8 in the program's
place and, for training, the reference on half of each batch and a step
that leaves its state unchanged. On a control seed the fp8 control
stands in the program's place, so its line's ``correct`` is the
control's; ``variants`` gives each reading's verdict by the same limits.

    python hbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2] [--seconds 2]

Each seed runs the cell as ``run.py`` does (set-up, a short window,
the check); one JSON line a seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from hbench.core import harness, spec

    if not torch.cuda.is_available():
        print("no CUDA card is visible", file=sys.stderr)
        return 2
    bench = spec.Bench(ROOT / "BENCHMARK.json")
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for s in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.run_cell(bench, args.workload, s, args.seconds, False, t_start=t0,
                             control="fp8" if s in controls else None, say=lambda _: None)
        line = json.dumps({"workload": args.workload, "seed": s, "numbers": r["numbers"],
                           "variants": r.get("variants"), "metrics": r["metrics"],
                           "correct": r["correct"], "seconds": time.perf_counter() - t0})
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
