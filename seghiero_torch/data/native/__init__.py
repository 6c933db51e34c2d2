"""ctypes bindings for the native transform core (``transform.cpp``), the
port's own copy of ``seghiero_tpu/data/native``.

The library is built with ``g++`` at first use into the git-ignored
``seghiero_torch/build/`` (named by a hash of the source and flags, so a
checkout builds it from its own source and reuses it afterwards). There
is no fallback: when the build fails, every entry point raises with the
compiler's message. ``transform.backend: native`` asks for this path.

Each entry point has a plain NumPy version beside it (``*_plain``) that
does the same float32 arithmetic in the same order, so the two give the
same bytes; the tests hold them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "transform.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
# no -march=native: FMA contraction of the bilinear blend would change its bytes
CXX_FLAGS = ["-O3", "-ffp-contract=off", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libseghiero_transform-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_so = os.path.join(tmp, out.name)
        try:
            res = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", tmp_so],
                                 capture_output=True, text=True, timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError("transform.backend: native needs g++ to build "
                               f"{SRC.name}, and none was found") from e
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC.name}:\n{res.stderr}")
        os.replace(tmp_so, out)  # atomic: a concurrent build never sees a torn file


def library() -> ctypes.CDLL:
    """The loaded transform library, built first if this checkout has none."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            c = ctypes.c_int
            for name, argtypes in (
                ("resize_bilinear_u8", [u8p, c, c, c, u8p, c, c]),
                ("resize_nearest_i32", [i32p, c, c, i32p, c, c]),
                ("hflip_u8", [u8p, c, c, c, u8p]),
                ("hflip_i32", [i32p, c, c, i32p]),
                ("lut_remap_i32", [i32p, ctypes.c_int64, i32p, c, ctypes.c_int32, i32p]),
            ):
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = None
            _lib = lib
        return _lib


def _size(size) -> Tuple[int, int]:
    h, w = (int(v) for v in size)
    if h <= 0 or w <= 0:
        raise ValueError(f"resize to a positive size, got {size}")
    return h, w


def resize_bilinear_u8(img: np.ndarray, size) -> np.ndarray:
    """uint8 HWC bilinear resize, half-pixel centers, no antialias."""
    h, w = _size(size)
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((h, w, img.shape[2]), np.uint8)
    library().resize_bilinear_u8(img, img.shape[0], img.shape[1], img.shape[2], out, h, w)
    return out


def resize_nearest_i32(mask: np.ndarray, size) -> np.ndarray:
    """int32 nearest resize: source index floor(dst · in / out)."""
    h, w = _size(size)
    mask = np.ascontiguousarray(mask, np.int32)
    out = np.empty((h, w), np.int32)
    library().resize_nearest_i32(mask, mask.shape[0], mask.shape[1], out, h, w)
    return out


def hflip_u8(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty_like(img)
    library().hflip_u8(img, img.shape[0], img.shape[1], img.shape[2], out)
    return out


def hflip_i32(mask: np.ndarray) -> np.ndarray:
    mask = np.ascontiguousarray(mask, np.int32)
    out = np.empty_like(mask)
    library().hflip_i32(mask, mask.shape[0], mask.shape[1], out)
    return out


def lut_remap_i32(mask: np.ndarray, lut: np.ndarray, ignore: int = 255) -> np.ndarray:
    """``lut[mask]`` with every id outside ``[0, len(lut))`` mapped to ``ignore``."""
    mask = np.ascontiguousarray(mask, np.int32)
    lut = np.ascontiguousarray(lut, np.int32)
    out = np.empty_like(mask)
    library().lut_remap_i32(mask.reshape(-1), mask.size, lut, len(lut), ignore,
                            out.reshape(-1))
    return out


# ---------------------------------------------------------------------------
# Plain NumPy versions: the same arithmetic, for the tests
# ---------------------------------------------------------------------------


def _taps(n_out: int, n_in: int):
    f32 = np.float32
    scale = f32(n_in) / f32(n_out)
    f = (np.arange(n_out, dtype=f32) + f32(0.5)) * scale - f32(0.5)
    i0 = np.floor(f).astype(np.int64)
    t = f - i0.astype(f32)
    return t, np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1)


def resize_bilinear_u8_plain(img: np.ndarray, size) -> np.ndarray:
    h, w = _size(size)
    src = np.asarray(img, np.uint8).astype(np.float32)
    ty, y0, y1 = _taps(h, src.shape[0])
    tx, x0, x1 = _taps(w, src.shape[1])
    one = np.float32(1)
    ty, tx = ty[:, None, None], tx[None, :, None]
    top = (one - tx) * src[y0][:, x0] + tx * src[y0][:, x1]
    bottom = (one - tx) * src[y1][:, x0] + tx * src[y1][:, x1]
    v = (one - ty) * top + ty * bottom
    return np.clip((v + np.float32(0.5)).astype(np.int32), 0, 255).astype(np.uint8)


def resize_nearest_i32_plain(mask: np.ndarray, size) -> np.ndarray:
    h, w = _size(size)
    mask = np.asarray(mask, np.int32)
    ys = (np.arange(h, dtype=np.int64) * mask.shape[0]) // h
    xs = (np.arange(w, dtype=np.int64) * mask.shape[1]) // w
    return np.ascontiguousarray(mask[ys[:, None], xs[None, :]])


def hflip_u8_plain(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(img, np.uint8)[:, ::-1])


def hflip_i32_plain(mask: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(mask, np.int32)[:, ::-1])


def lut_remap_i32_plain(mask: np.ndarray, lut: np.ndarray, ignore: int = 255) -> np.ndarray:
    mask, lut = np.asarray(mask, np.int32), np.asarray(lut, np.int32)
    valid = (mask >= 0) & (mask < len(lut))
    return np.where(valid, lut[np.clip(mask, 0, len(lut) - 1)], ignore).astype(np.int32)
