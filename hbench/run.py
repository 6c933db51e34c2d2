"""Run one cell of the benchmark once on this machine's card.

    python hbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the correctness
comparison read, beside its limit (also the last lines of standard
error). Exits non-zero, printing no result, without a CUDA card or with
fewer cards than the cell asks for.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "hbench" / ".cache"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    sys.path.insert(0, str(ROOT))
    import torch

    from hbench.core import harness, spec

    if not torch.cuda.is_available():
        print("no CUDA card is visible: the benchmark runs on the card only", file=sys.stderr)
        return 2
    bench = spec.Bench(ROOT / "BENCHMARK.json")
    need = int(bench.workload(args.workload)["chips"])
    if torch.cuda.device_count() < need:
        print(f"{args.workload} needs {need} cards, {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 2
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start=T_START, say=lambda s: print(s, flush=True))
    for mod in ("jax", "seghiero_tpu"):
        assert mod not in sys.modules, f"{mod} was imported: the benchmark measures the port"
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
