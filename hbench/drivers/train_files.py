"""Training from image files: set-up writes the traffic's ``frames``
image and mask PNGs of ``frame_hw`` from the seed (all cores), builds the
raw cache through the program's own cache CLI (``python -m
seghiero_torch.data.cache``, in process), and feeds ``train_step`` from
the program's ``BatchLoader`` over ``RawCacheDataset`` with the config's
transforms, epoch after epoch with ``set_epoch`` between them, as ``fit``
does. Each wait for a batch is the ``loader_wait`` span."""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
from PIL import Image

from hbench.core import scene
from hbench.core.trainlib import TrainDriver


def write_frames(seed: int, n: int, hw, n_classes: int, root: Path, device) -> None:
    """``n`` scenes as ``train/images/NNNN.png`` and ``train/masks/NNNN.png``."""
    img_dir, msk_dir = root / "train" / "images", root / "train" / "masks"
    img_dir.mkdir(parents=True)
    msk_dir.mkdir(parents=True)
    gen = scene.generator(seed, device, stream=2)

    def save(args):
        i, img, fine = args
        Image.fromarray(img).save(img_dir / f"{i:04d}.png", compress_level=1)
        Image.fromarray(fine).save(msk_dir / f"{i:04d}.png", compress_level=1)

    chunk = 8
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        for i0 in range(0, n, chunk):
            k = min(chunk, n - i0)
            imgs, fine = scene.scenes(gen, k, hw, n_classes)
            imgs, fine = imgs.cpu().numpy(), fine.to(torch.uint8).cpu().numpy()
            list(pool.map(save, [(i0 + j, imgs[j], fine[j]) for j in range(k)]))


class Driver(TrainDriver):
    def make_feed(self):
        import yaml
        from seghiero_torch.config import SegHieroConfig
        from seghiero_torch.data import cache
        from seghiero_torch.data.dataset import build_dataset
        from seghiero_torch.data.pipeline import BatchLoader

        c, t = self.ctx, self.ctx.traffic
        self.tmp = Path(tempfile.mkdtemp(prefix="hbench-frames-"))
        write_frames(c.seed, int(t["frames"]), tuple(t["frame_hw"]), c.tree.n_fine,
                     self.tmp / "data", self.dev)
        port = json.loads(json.dumps(self.port))
        port["dataset"].update(root=str(self.tmp / "data"), cache_dir=str(self.tmp / "cache"))
        path = self.tmp / "config.yaml"
        path.write_text(yaml.safe_dump(port))
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            if cache.main(["--config", str(path), "--splits", "train"]) != 0:
                raise RuntimeError(f"the cache CLI failed:\n{log.getvalue()}")
        cfg = SegHieroConfig.from_dict(port)
        tr = cfg.training
        ds = build_dataset(cfg, "train", seed=tr.seed, include_levels=False, verbose=False)
        self.loader = BatchLoader(ds, tr.batch_size, shuffle=True, drop_last=True, seed=tr.seed,
                                  device=self.dev, prefetch=int(t.get("prefetch", 2)),
                                  num_workers=tr.num_workers)
        self._epoch_iter = None
        return self._epochs()

    def _epochs(self):
        epoch = 0
        while True:
            self.loader.set_epoch(epoch)
            self._epoch_iter = iter(self.loader)
            yield from self._epoch_iter
            epoch += 1

    def next_batch(self):
        with self.ctx.spans.span("loader_wait"):
            return next(self.feed)

    def close_feed(self) -> None:
        # let the loader's prefetch thread finish its epoch, then stop its pool
        if self._epoch_iter is not None:
            for _ in self._epoch_iter:
                pass
        if self.loader._pool is not None:
            self.loader._pool.shutdown(wait=True)
        shutil.rmtree(self.tmp, ignore_errors=True)
