"""Static SASS counts of the port's fused loss, RMI and decode kernels.

``python -m seghiero_torch.ops.sass_counts [LIBRARY]`` builds the port's
kernel library (or reads LIBRARY), disassembles it with ``cuobjdump
-sass`` and prints one JSON object: for each kernel below, its
instructions, MUFU operations, FFMAs and tensor-core products (HMMA) in
all, and the instructions, MUFU operations, FFMAs, HMMAs, bf16 packs
(F2FP), f32 multiplies and adds (FMUL, FADD), shared-memory loads (LDS),
global loads (LDG), asynchronous copies
(LDGSTS), local-memory loads and stores (LDL, STL: register spills) and
branches of one innermost loop (a backward branch's span, both sides of
its branches), leaving out the instructions ptxas pads with under an
always-false guard (``@!PT``). The loop is the one holding the most of the
kernel's key operation:

* MUFU for the fused loss kernels (the per-pixel loop; the forward's
  covers its 4 pixels of one channel);
* FFMA for ``gram18_kernel`` (#6 / #6f: the steady row loop of its
  interior tiles), ``grad_maps_kernel`` (#8 / #8f: the row loop) and
  ``residual_f32_kernel`` (#7: the row loop, unrolled by 3 output rows);
* HMMA for ``residual_mma_kernel`` (#7f: the input-row loop of a warp
  whose columns end inside the map);
* FMUL for ``upsample_argmax_kernel`` (#3, f32 and bf16 logits: the
  channel loop of a level, 16 outputs a thread).

An older tree's kernels are counted by passing their entries, e.g.
``{**KERNELS, "residual_partial_kernel<false>": ("residual_partial_kernelILb0E",
"FFMA", 32)}`` for #7 before its redesign (one column a thread, one row an
iteration).

The f32 and bf16-view instantiations of a template are counted apart.
Where an iteration of the loop covers a known number of output pixels a
warp (an RMI kernel's row), the loop's instructions per 16 of them are
printed too. Each kernel's registers and spill bytes are those ``ptxas
-v`` wrote into the build's log beside the library (``<library>.log``;
null without one). A diagnostic for the card: ``ncu`` does not run
there, so the instruction count per pixel is read from the code. LIBRARY
may be another tree's build, so two versions of a kernel can be counted
by one script.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

# name → (substring of the mangled SASS function name, key operation,
# output pixels a warp covers per iteration of the key loop, or None; for
# the decode, outputs of one channel)
KERNELS = {
    "hiera2_fwd_kernel": ("hiera2_fwd_kernel", "MUFU", None),
    "hiera2_bwd_kernel": ("hiera2_bwd_kernel", "MUFU", None),
    "gram18_kernel<false>": ("gram18_kernelILb0E", "FFMA", 128),
    "gram18_kernel<true>": ("gram18_kernelILb1E", "FFMA", 128),
    "grad_maps_kernel<false>": ("grad_maps_kernelILb0E", "FFMA", 128),
    "grad_maps_kernel<true>": ("grad_maps_kernelILb1E", "FFMA", 128),
    "residual_f32_kernel": ("residual_f32_kernel", "FFMA", 3 * 128),
    "residual_mma_kernel": ("residual_mma_kernel", "HMMA", 64),
    "upsample_argmax_kernel<float>": ("upsample_argmax_kernelIfE", "FMUL", 16 * 32),
    "upsample_argmax_kernel<bf16>": ("upsample_argmax_kernelI13__nv_bfloat16E", "FMUL", 16 * 32),
}
LOOP_OPS = ("MUFU", "FFMA", "HMMA", "F2FP", "FMUL", "FADD", "LDS", "LDG", "LDGSTS", "LDL",
            "STL")


def _mnemonic(op: str) -> str:
    """The opcode of one SASS instruction, without its guard predicate; ""
    for one guarded by ``@!PT`` (never executed: ptxas's padding)."""
    op = op.strip()
    if op.startswith("@!PT "):
        return ""
    return re.sub(r"^@!?U?P\w+\s+", "", op).split(" ", 1)[0]


def _count(mnems, prefix: str) -> int:
    if prefix == "LDG":  # LDGSTS (cp.async) is counted on its own
        return sum(m.startswith("LDG") and not m.startswith("LDGSTS") for m in mnems)
    return sum(m.startswith(prefix) for m in mnems)


def ptxas_usage(log: str, pattern: str) -> dict:
    """Registers and spill bytes of the kernel whose mangled name holds
    ``pattern``, from a ``ptxas -v`` log."""
    for chunk in log.split("Compiling entry function '")[1:]:
        if pattern not in chunk.split("'", 1)[0]:
            continue
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        return {"registers": int(regs.group(1)) if regs else None,
                "spill_store_bytes": int(spill.group(1)) if spill else None,
                "spill_load_bytes": int(spill.group(2)) if spill else None}
    return {"registers": None, "spill_store_bytes": None, "spill_load_bytes": None}


def count_sass(text: str, log: str, kernels=KERNELS) -> dict:
    """The counts of each kernel in ``kernels`` found in ``cuobjdump -sass``
    output ``text``, with its registers and spills from the ptxas log."""
    out = {}
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        head = func.split("\n", 1)[0]
        name = next((k for k, spec in kernels.items() if spec[0] in head), None)
        if name is None:
            continue
        pattern, key, pixels = kernels[name]
        ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)
        addr = [int(a, 16) for a, _ in ins]
        mnems = [_mnemonic(o) for _, o in ins]
        best = (0, 0, 0, 0)  # (key ops, −instructions, start, end): the innermost such loop
        for i, op in enumerate(o for _, o in ins):
            m = re.search(r"BRA (0x[0-9a-f]+)", op)
            if m and int(m.group(1), 16) < addr[i] and int(m.group(1), 16) in addr:
                j = addr.index(int(m.group(1), 16))
                best = max(best, (_count(mnems[j:i + 1], key), -(i + 1 - j), j, i + 1))
        loop = mnems[best[2]:best[3]]
        n_loop = sum(map(bool, loop))
        out[name] = {"instructions": sum(map(bool, mnems)), "mufu": _count(mnems, "MUFU"),
                     "ffma": _count(mnems, "FFMA"), "hmma": _count(mnems, "HMMA"),
                     "loop_instructions": n_loop,
                     **{f"loop_{k.lower()}": _count(loop, k) for k in LOOP_OPS},
                     "loop_branches": _count(loop, "BRA"),
                     "loop_instructions_per_16_pixels": n_loop * 16 / pixels if pixels else None,
                     **ptxas_usage(log, pattern)}
    return out


def sass_counts(lib_path: str, kernels=KERNELS) -> dict:
    from torch.utils.cpp_extension import CUDA_HOME

    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", lib_path], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    log_file = Path(lib_path).with_suffix(".log")
    return count_sass(text, log_file.read_text() if log_file.exists() else "", kernels)


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
