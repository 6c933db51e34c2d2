"""Host→device input pipeline (counterpart of
``seghiero_tpu/data/pipeline.py``): images travel as uint8 and are
normalized on the device where they are consumed; ``BatchLoader``
collates and prefetches batches on a background thread."""

from __future__ import annotations

import functools
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from seghiero_torch import trace


@functools.lru_cache(maxsize=16)
def _scaled_by_255(values: tuple, device: torch.device) -> torch.Tensor:
    """``255 · values`` as an f32 tensor on ``device``, made once (a copy
    from host memory in every step would wait for the card)."""
    return torch.tensor(values, dtype=torch.float32, device=device) * 255.0


def normalize_images(
    images_u8: torch.Tensor,
    mean=(0.485, 0.456, 0.406),
    std=(0.229, 0.224, 0.225),
) -> torch.Tensor:
    """uint8 NHWC → f32 ``(x − 255·mean) / (255·std)`` on the tensor's
    device, matching torchvision ToTensor+Normalize."""
    dev = images_u8.device
    mean = _scaled_by_255(tuple(float(m) for m in mean), dev)
    std = _scaled_by_255(tuple(float(s) for s in std), dev)
    return (images_u8.to(torch.float32) - mean) / std


def _collate(samples) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class BatchLoader:
    """Iterable over collated batches of tensors on ``device`` — the port of
    ``seghiero_tpu/data/pipeline.py:47-171`` ``BatchLoader``, with the same
    index order (per-epoch shuffle from ``SeedSequence([seed, epoch])``),
    the same eval-tail padding (repeats of sample 0 with labels forced to
    255) and the same background thread preparing ``prefetch`` batches
    ahead. On a CUDA device the worker thread also pins each batch, and the
    copy to the card is issued with ``non_blocking=True``. Making a batch
    is the span ``loader.batch`` (in the worker thread), the consumer's
    wait for one ``loader.wait``."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 0, device=None, prefetch: int = 2,
                 num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.device = torch.device(device) if device is not None else None
        self.prefetch = max(0, prefetch)
        self.epoch = 0
        self._pool = None
        if num_workers and num_workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=num_workers)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch])).shuffle(idx)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for i in range(0, stop, self.batch_size):
            yield idx[i : i + self.batch_size]

    def make_batch(self, indices) -> Dict[str, np.ndarray]:
        """The collated numpy batch of ``indices`` (padded to the batch
        size). A dataset with ``get_batch`` (the raw cache) collates it
        itself, its labels in their storage dtype, unless a thread pool
        fetches the samples."""
        if hasattr(self.dataset, "get_batch") and self._pool is None:
            batch = self.dataset.get_batch(indices)
        elif self._pool is not None:
            batch = _collate(list(self._pool.map(self.dataset.__getitem__, map(int, indices))))
        else:
            batch = _collate([self.dataset[int(i)] for i in indices])
        pad = self.batch_size - len(indices)
        if pad > 0:
            for k, v in batch.items():
                filler = np.repeat(v[:1], pad, axis=0)
                if k != "image":
                    filler = np.full_like(filler, 255)  # ignored by losses and metrics
                batch[k] = np.concatenate([v, filler], axis=0)
        return batch

    def _host_batch(self, indices) -> Dict[str, torch.Tensor]:
        with trace.span("loader.batch"):
            batch = {k: torch.from_numpy(v) for k, v in self.make_batch(indices).items()}
            if self.device is not None and self.device.type == "cuda":
                batch = {k: v.pin_memory() for k, v in batch.items()}
        return batch

    def _put(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.device is None:
            return batch
        return {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        batches = list(self._batch_indices())
        host_iter = (self._host_batch(ix) for ix in batches)
        if self.prefetch == 0:
            for b in host_iter:
                yield self._put(b)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: list = []

        def worker():
            try:
                for b in host_iter:
                    q.put(b)
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        for _ in batches:
            with trace.span("loader.wait"):
                b = q.get()
            if b is sentinel:  # the worker failed
                break
            yield self._put(b)
        else:
            q.get()  # the worker's sentinel, behind the last batch
        if err:
            raise err[0]
