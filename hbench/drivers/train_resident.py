"""Training on resident batches: ``train_step`` back to back on a pool of
distinct batches made on the card at set-up (the traffic's
``pool_batches``), cycled in order. The loader is bypassed."""

from __future__ import annotations

import itertools

import torch

from hbench.core import scene
from hbench.core.trainlib import TrainDriver


class Driver(TrainDriver):
    def make_feed(self):
        c = self.ctx
        n = int(c.traffic["pool_batches"]) * self.batch_size
        images, fine = scene.scenes(scene.generator(c.seed, self.dev, stream=1), n, self.hw,
                                    c.tree.n_fine)
        fine = fine.to(torch.int32)
        b = self.batch_size
        pool = [{"image": images[i:i + b].contiguous(), "fine": fine[i:i + b].contiguous()}
                for i in range(0, n, b)]
        return itertools.cycle(pool)
