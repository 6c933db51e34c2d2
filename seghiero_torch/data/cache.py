"""Raw decoded-sample cache (``dataset.cache: raw``), the port's own copy of
``seghiero_tpu/data/cache.py``.

Decoding a PNG costs milliseconds per image on one core, every epoch.
``RawCacheDataset`` decodes every (image, mask) pair once, at the config's
resize, and memory-maps the raw arrays:

  * ``images.u8`` — uint8 [N, H, W, 3]
  * ``fine.raw``  — the fine mask, uint8 when the label space fits
    (fewer than 255 fine classes with the 255 ignore id), else int32
  * ``meta.json`` — written last; the directory is named by a fingerprint
    of the file list, sizes and mtimes, the resize, the backend and the
    storage dtype, so any change builds a new cache

Later epochs read at page-cache speed and re-run only the random part of
the transform (``JointTransform.apply_arrays``) with the same per-(seed,
epoch, index) generator, so a cached sample equals the uncached one bit
for bit. ``get_batch`` collates a batch in one gather, keeps the labels in
their storage dtype (uint8: a quarter of the host-to-card bytes; the
train step widens them on the card) and derives the level masks by one
256-entry LUT take per level.

Prebuild or prune offline: ``python -m seghiero_torch.data.cache --config
cfg.yaml [--splits train,val] [--prune-days D]``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from seghiero_torch.data.dataset import read_pair
from seghiero_torch.hierarchy import Hierarchy


def _fingerprint(paths: List[str], extra: dict) -> str:
    h = hashlib.sha256()
    for p in paths:
        st = os.stat(p)
        h.update(f"{p}:{st.st_size}:{st.st_mtime_ns};".encode())
    h.update(json.dumps(extra, sort_keys=True).encode())
    return h.hexdigest()[:24]


def _take_lut(lut: np.ndarray, ignore_index: int) -> np.ndarray:
    """A length-n_fine LUT extended to 256 entries, every id out of range
    (the 255 ignore id included) mapped to ``ignore_index``: one take on a
    uint8 mask. uint8 when the level's ids fit, else int32."""
    vals = np.asarray(lut)
    narrow = ignore_index == 255 and (vals.size == 0 or int(vals.max()) < 255)
    dt = np.uint8 if narrow else np.int32
    full = np.full(256, ignore_index, dt)
    full[: len(vals)] = vals.astype(dt)
    return full


def prune_stale(cache_root: str, older_than_days: float = 30.0,
                tmp_older_than_hours: float = 2.0) -> int:
    """Delete abandoned state under ``cache_root``: ``*.tmp.*`` build
    directories older than ``tmp_older_than_hours`` (a killed build's)
    and ``raw_*`` caches whose ``meta.json`` was not touched for
    ``older_than_days`` (every open touches it). Returns how many
    directories went. Every cache open runs it."""
    if not os.path.isdir(cache_root):
        return 0
    now = time.time()
    removed = 0
    for name in os.listdir(cache_root):
        path = os.path.join(cache_root, name)
        if not os.path.isdir(path):
            continue
        try:
            if ".tmp." in name:
                stale = now - os.path.getmtime(path) > tmp_older_than_hours * 3600
            elif name.startswith("raw_"):
                meta = os.path.join(path, "meta.json")
                stamp = os.path.getmtime(meta if os.path.exists(meta) else path)
                stale = now - stamp > older_than_days * 86400
            else:
                stale = False
        except OSError:  # removed by another process meanwhile
            continue
        if stale:
            shutil.rmtree(path, ignore_errors=True)
            removed += 1
    return removed


class RawCacheDataset:
    """A ``HieroDataset`` (``img_paths``, ``msk_paths``, ``transform``,
    ``hierarchy``, ``split``, ``seed``) behind a raw memmap cache of its
    base (resize-only) arrays; the wrapped transform's ``apply_arrays``
    gives each epoch's augmentation."""

    def __init__(self, base, cache_dir: Optional[str] = None, include_levels: bool = True,
                 verbose: bool = True):
        self.base = base
        self.hierarchy: Hierarchy = base.hierarchy
        self.transform = base.transform
        self.split = base.split
        self.seed = base.seed
        self.epoch = getattr(base, "epoch", 0)
        self.include_levels = include_levels

        h, w = self._hw = self._base_hw()
        hier = self.hierarchy
        narrow = hier.n_fine < 255 and hier.ignore_index == 255
        self._fine_dtype = np.uint8 if narrow else np.int32
        # the take-LUTs exist for the uint8 storage only; the int32 storage
        # maps through the hierarchy in get_batch
        self._lut_coarse = self._lut_super = None
        if narrow:
            self._lut_coarse = _take_lut(hier.fine_to_coarse, hier.ignore_index)
            if hier.has_super:
                self._lut_super = _take_lut(hier.fine_to_super, hier.ignore_index)

        extra = {"hw": [h, w], "backend": self.transform.backend,
                 "fine_dtype": np.dtype(self._fine_dtype).name, "version": 1}
        fp = _fingerprint(list(base.img_paths) + list(base.msk_paths), extra)
        root = cache_dir or os.path.join(os.path.expanduser("~"), ".cache", "seghiero_torch")
        self.cache_path = os.path.join(root, f"raw_{self.split}_{fp}")
        self.build_seconds = self._build_if_missing(verbose)
        self._open_memmaps()
        # mark this cache in use, and sweep the root of abandoned ones
        try:
            os.utime(os.path.join(self.cache_path, "meta.json"))
            prune_stale(os.path.dirname(self.cache_path))
        except OSError:
            pass

    def _open_memmaps(self):
        n, (h, w) = len(self.base), self._hw
        self.images = np.memmap(os.path.join(self.cache_path, "images.u8"), np.uint8, "r",
                                shape=(n, h, w, 3))
        self.fine = np.memmap(os.path.join(self.cache_path, "fine.raw"), self._fine_dtype,
                              "r", shape=(n, h, w))

    def __getstate__(self):
        """Pickle without the memmaps (a memmap pickles as its whole
        contents); the copy reopens them from the path."""
        state = dict(self.__dict__)
        state.pop("images", None)
        state.pop("fine", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._open_memmaps()

    def _base_hw(self):
        if self.transform.resize is not None:
            return tuple(self.transform.resize)
        # no resize: every file must have the first one's size
        from PIL import Image

        with Image.open(self.base.img_paths[0]) as im:
            w, h = im.size
        return (h, w)

    def _build_if_missing(self, verbose: bool) -> Optional[float]:
        """Build into a private tmp directory, then rename it into place:
        concurrent builds each write their own and the loser of the
        rename drops its copy, so nothing writes into a directory another
        process may have mapped. Returns the build's seconds (None when the
        cache was there)."""
        if os.path.exists(os.path.join(self.cache_path, "meta.json")):
            return None
        tmp = f"{self.cache_path}.tmp.{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        n, (h, w) = len(self.base), self._hw
        t0 = time.perf_counter()
        img_mm = np.memmap(os.path.join(tmp, "images.u8"), np.uint8, "w+", shape=(n, h, w, 3))
        fin_mm = np.memmap(os.path.join(tmp, "fine.raw"), self._fine_dtype, "w+",
                           shape=(n, h, w))
        # no augmentation (rng None: the resize alone): each epoch replays it
        for i in range(n):
            img, fine = read_pair(self.base.img_paths[i], self.base.msk_paths[i])
            arr, mask = self.transform(img, fine, None)
            img_mm[i] = arr
            fin_mm[i] = mask.astype(self._fine_dtype)
        img_mm.flush()
        fin_mm.flush()
        del img_mm, fin_mm
        seconds = time.perf_counter() - t0
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"n": n, "hw": [h, w], "built_s": seconds}, f)
        try:
            os.rename(tmp, self.cache_path)
        except OSError:  # a concurrent build won the rename: use its cache
            shutil.rmtree(tmp, ignore_errors=True)
        if verbose:
            print(f"[data] raw cache built: {n} samples at {h}x{w} in {seconds:.1f}s "
                  f"-> {self.cache_path}")
        return seconds

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.base, "set_epoch"):
            self.base.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.base)

    def _rng(self, idx: int):
        if self.split != "train":
            return None
        return np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch, idx]))

    def _augment_one(self, idx: int):
        return self.transform.apply_arrays(np.asarray(self.images[idx]),
                                           np.asarray(self.fine[idx]), self._rng(idx))

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        image, fine = self._augment_one(idx)
        out = {"image": image, "fine": fine}
        if self.include_levels:
            h = self.hierarchy
            out["coarse"] = h.map_fine_labels(fine, "coarse")
            if h.has_super:
                out["super"] = h.map_fine_labels(fine, "super")
        return out

    def get_batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """The collated batch of ``indices`` (``BatchLoader``'s fast path):
        the per-sample augmentation of ``__getitem__``, labels in the
        storage dtype, level masks by one LUT take each."""
        idx = [int(i) for i in indices]
        aug = self.transform
        plain = self.split != "train" or (
            aug.hflip_prob == 0 and aug.scale_range is None and aug.color_jitter == 0)
        if plain:  # one fancy-index gather collates the batch
            images, fine = self.images[idx], self.fine[idx]
        else:
            pairs = [self._augment_one(i) for i in idx]
            images = np.stack([p[0] for p in pairs])
            fine = np.stack([p[1] for p in pairs])
        out = {"image": np.ascontiguousarray(images),
               "fine": np.ascontiguousarray(fine, dtype=self._fine_dtype)}
        if self.include_levels:
            if self._lut_coarse is not None:
                out["coarse"] = self._lut_coarse[out["fine"]]
                if self._lut_super is not None:
                    out["super"] = self._lut_super[out["fine"]]
            else:
                h = self.hierarchy
                out["coarse"] = h.map_fine_labels(out["fine"], "coarse")
                if h.has_super:
                    out["super"] = h.map_fine_labels(out["fine"], "super")
        return out


def main(argv=None) -> int:
    """Prebuild the raw caches of a config's splits (the cache is forced on
    here, whatever the config says), and optionally prune the cache root."""
    import argparse

    from seghiero_torch.config import load_config
    from seghiero_torch.data.dataset import build_dataset

    p = argparse.ArgumentParser(prog="python -m seghiero_torch.data.cache",
                                description="Prebuild (or prune) the raw decoded-sample cache")
    p.add_argument("--config", required=True,
                   help="YAML config of a file-backed dataset")
    p.add_argument("--splits", default="train,val")
    p.add_argument("--prune-days", type=float, default=None,
                   help="also prune caches untouched this many days")
    args = p.parse_args(argv)

    import dataclasses

    cfg = load_config(args.config)
    if cfg.dataset.kind != "files":
        raise SystemExit(f"dataset.kind: {cfg.dataset.kind} has no files to cache")
    if cfg.dataset.cache != "raw":
        cfg = dataclasses.replace(cfg, dataset=dataclasses.replace(cfg.dataset, cache="raw"))
    for split in args.splits.split(","):
        ds = build_dataset(cfg, split.strip(), verbose=True)
        mib = os.path.getsize(os.path.join(ds.cache_path, "images.u8")) / 2**20
        print(f"→ {split}: {len(ds)} samples cached at {ds.cache_path} ({mib:.1f} MiB images)")
        if args.prune_days is not None:
            n = prune_stale(os.path.dirname(ds.cache_path), older_than_days=args.prune_days)
            print(f"→ pruned {n} stale cache dirs")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
