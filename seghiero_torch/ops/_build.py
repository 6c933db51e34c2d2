"""Build and load the port's CUDA kernels.

Every ``*.cu`` under ``seghiero_torch/csrc`` is compiled for Hopper by its
own ``nvcc`` process (all started together), and the objects are linked
into one shared library with a plain C interface that ``ctypes`` loads —
seconds to build, where a source that includes PyTorch's headers takes
minutes. The library lands in ``seghiero_torch/build/`` (git-ignored),
named by a hash of the sources and flags, so a checkout builds it at
first use from its own sources and reuses it afterwards.

The build happens inside :func:`library`, never at import: machines
without ``nvcc`` or a card import every module and run the kernels'
plain PyTorch versions instead (the wrappers decide by the tensor's
device, never by what is installed).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = GENCODE + [
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",  # registers, shared memory and spills per kernel, kept in the log
    f"-I{CSRC_DIR}",
]

# argtypes of every exported function: pointers and streams as c_void_p
# (a plain int would be cut to 32 bits), sizes as c_int
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # x, k9, out, B, H, W, C, dtype, vec, device, stream
    "seghiero_dw3x3_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, k9, out, B, H, W, C, dilation, dtype, vec, device, stream
    "seghiero_dw3x3_dil_fwd": [_P, _P, _P] + [_I] * 8 + [_P],
    # logits, B, C, h, w, dtype, n_levels, lo0, hi0, lo1, hi1, lo2, hi2,
    # out0, out1, out2, device, stream
    "seghiero_upsample_argmax": [_P] + [_I] * 12 + [_P, _P, _P, _I, _P],
    # x, g, partial, dk, B, H, W, C, dtype, vec, P, device, stream
    "seghiero_dw3x3_wgrad": [_P] * 4 + [_I] * 8 + [_P],
    # B, H, W -> rows of seghiero_dw3x3_wgrad's partial-sum scratch
    "seghiero_dw3x3_wgrad_partials": [_I] * 3,
    # lo, t_fine, t_coarse, tab, partial, sums, B, C, h, w, nf, nc, P, device, stream
    "seghiero_hiera2_fwd": [_P] * 6 + [_I] * 8 + [_P],
    # B, h, w -> rows of seghiero_hiera2_fwd's partial-sum scratch
    "seghiero_hiera2_fwd_partials": [_I] * 3,
    # lo, t_fine, t_coarse, tab, gsum, dlo, B, C, h, w, nf, nc, device, stream
    "seghiero_hiera2_bwd": [_P] * 6 + [_I] * 7 + [_P],
    # la, pr, partial, g18, BC, H, W, scratch, bf16, device, stream
    "seghiero_rmi_gram18": [_P] * 4 + [_I] * 6 + [_P],
    # la, pr, w, partial, a, BC, H, W, nblk, bf16, device, stream
    "seghiero_rmi_residual": [_P] * 5 + [_I] * 6 + [_P],
    # la, pr, p, dpr, BC, H, W, bf16, device, stream
    "seghiero_rmi_grad_maps": [_P] * 4 + [_I] * 5 + [_P],
    # q, k, v, o, lse, strides, B, heads, N, M, d, q_rows, device, stream
    "seghiero_sr_attention_fwd": [_P] * 6 + [_I] * 7 + [_P],
    # q, k, v, o, dout, dq, dk, dv, lse, delta, ws, strides, B, heads, N, M,
    # d, splits, device, stream
    "seghiero_sr_attention_bwd": [_P] * 12 + [_I] * 7 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build did: {"seconds", "cached", "path", "log"}
build_info: Dict[str, object] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME); the port's "
        "CUDA kernels need the CUDA toolkit to build"
    )


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def _library_path() -> Path:
    units, headers = _sources()
    # the -I flag (last) names the checkout's location, not what is built
    h = hashlib.sha256(" ".join(NVCC_FLAGS[:-1]).encode())
    for f in units + headers:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libseghiero_kernels-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    units, _ = _sources()
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in units:
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        logs, failed = [], []
        for src, _, p in procs:
            text, _ = p.communicate()
            logs.append(f"== {src.name}\n{text}")
            if p.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
        tmp_so = os.path.join(tmp, out.name)
        link = subprocess.run(
            [nvcc, *GENCODE, "-shared", *(o for _, o, _ in procs), "-o", tmp_so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, out)  # atomic: concurrent builders never see a torn file
    (out.with_suffix(".log")).write_text(log)
    build_info.update(
        seconds=time.perf_counter() - t0, cached=False, path=str(out), log=log
    )


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this checkout has none."""
    global _lib
    with _lock:
        if _lib is None:
            path = _library_path()
            if path.exists():
                log_file = path.with_suffix(".log")
                build_info.update(
                    seconds=0.0, cached=True, path=str(path),
                    log=log_file.read_text() if log_file.exists() else "",
                )
            else:
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.seghiero_error_string.argtypes = [ctypes.c_int]
            lib.seghiero_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a kernel entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.seghiero_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def on_card(x, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (run
    the plain version); raises for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {x.device}")
    return True


DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def dtype_code(dtype) -> int:
    name = str(dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    return DTYPE_CODES[name]
