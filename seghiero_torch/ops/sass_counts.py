"""Static SASS counts of the fused loss kernels in the built library.

``python -m seghiero_torch.ops.sass_counts [LIBRARY]`` builds the port's
kernel library (or reads LIBRARY), disassembles it with ``cuobjdump
-sass`` and prints one JSON object: for each of ``hiera2_fwd_kernel`` and
``hiera2_bwd_kernel``, its instructions and MUFU operations in all, and
those of the innermost loop (a backward branch's span) holding the most
MUFU operations — the per-pixel loop, both sides of its branches (the
forward's covers its 4 pixels of one channel). A diagnostic for the card:
``ncu`` does not run there, so the instruction count per pixel is read
from the code.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

KERNELS = ("hiera2_fwd_kernel", "hiera2_bwd_kernel")


def sass_counts(lib_path: str, kernels=KERNELS) -> dict:
    from torch.utils.cpp_extension import CUDA_HOME

    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", lib_path], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        name = next((k for k in kernels if k in func.split("\n", 1)[0]), None)
        if name is None:
            continue
        ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)
        addr = [int(a, 16) for a, _ in ins]
        ops = [o for _, o in ins]
        best = (0, 0, 0)  # (MUFU, −instructions, branches): the innermost such loop
        for i, op in enumerate(ops):
            m = re.search(r"BRA (0x[0-9a-f]+)", op)
            if m and int(m.group(1), 16) < addr[i] and int(m.group(1), 16) in addr:
                body = ops[addr.index(int(m.group(1), 16)):i + 1]
                mufu = sum("MUFU" in o for o in body)
                best = max(best, (mufu, -len(body), sum("BRA" in o for o in body)))
        out[name] = {"instructions": len(ops), "mufu": sum("MUFU" in o for o in ops),
                     "loop_instructions": -best[1], "loop_mufu": best[0],
                     "loop_branches": best[2]}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        path = argv[0]
    else:
        from seghiero_torch.ops import _build

        _build.library()
        path = str(_build.build_info["path"])
    print(json.dumps(sass_counts(path)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
