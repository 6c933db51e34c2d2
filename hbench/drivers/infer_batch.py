"""Batched offline inference: ``Predictor.predict_array`` (the infer CLI's
per-batch entry) back to back on batches of ``batch`` distinct uint8
images at the config's input size, from a host pool of ``pool`` images
made from the seed; each call returns every level's masks on the host.
After the window the reference checks ``sample`` calls drawn from the
seed among those the window made (a reservoir sample)."""

from __future__ import annotations

import time

import numpy as np
import torch

from hbench.core import flops, geometry, predictlib, scene


class Driver:
    kind = "infer"

    def __init__(self, ctx):
        self.ctx = ctx
        self.dev = torch.device(ctx.device)
        self.port = ctx.port_config("infer")
        t = ctx.traffic
        self.batch, self.n_pool, self.n_sample = int(t["batch"]), int(t["pool"]), int(t["sample"])
        self.hw = tuple(self.port["transform"]["resize"])

    def setup(self) -> None:
        c = self.ctx
        sd = predictlib.seeded_weights(c.reference, self.port, c.tree, c.seed, self.dev)
        self.bn_stats = {k: v.clone() for k, v in sd.items() if k.endswith(("running_mean",
                                                                           "running_var"))}
        self.pred = predictlib.predictor(self.port, sd, self.dev)
        del sd
        imgs, _ = scene.scenes(scene.generator(c.seed, self.dev, stream=3), self.n_pool,
                               self.hw, c.tree.n_fine)
        self.pool = imgs.cpu().numpy()
        self.calls = 0
        self.rng = np.random.default_rng(np.random.SeedSequence([int(c.seed), 5]))
        for _ in range(2):
            self._call()
        if c.trace:  # the kernel counts' reference pass, before the traced segment
            self.unit = geometry.unit(self.batch, self.hw, c.tree, c.reference, self.port["model"])

    def _group(self, i: int) -> np.ndarray:
        groups = self.n_pool // self.batch
        a = (i % groups) * self.batch
        return self.pool[a:a + self.batch]

    def _call(self):
        with self.ctx.spans.span("predict"):
            masks = self.pred.predict_array(self._group(self.calls))
        self.calls += 1
        return masks

    def window(self, seconds: float):
        self.sample, n = [], 0
        t0 = time.perf_counter()
        while True:
            masks = self._call()
            item = (self.calls - 1, masks)
            if n < self.n_sample:  # reservoir sampling, from the seed
                self.sample.append(item)
            else:
                j = int(self.rng.integers(0, n + 1))
                if j < self.n_sample:
                    self.sample[j] = item
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        dt = time.perf_counter() - t0
        return {"metrics": {"infer_images_per_s": n * self.batch / dt},
                "attempted": n * self.batch, "failed": 0, "units": n, "seconds": dt}

    def segment(self, calls: int):
        for _ in range(calls):
            self._call()
        return [self.unit] * calls

    def trace_extras(self):
        return {"flops_per_image": flops.per_image(
            self.ctx.reference.build(self.port["model"], self.ctx.tree), self.hw, False)}

    def release(self) -> None:
        del self.pred
        predictlib.free(self.dev)

    def check(self, control: bool = False):
        c = self.ctx
        sd = predictlib.seeded_weights(c.reference, self.port, c.tree, c.seed, self.dev,
                                       self.bn_stats)
        ref = predictlib.Reference(c.reference, self.port, c.tree, sd, self.dev)
        del sd
        gap, low = 0.0, 0.0
        for call, masks in self.sample:
            for j, img in enumerate(self._group(call)):
                mine = {lvl: m[j] for lvl, m in masks.items()}
                if control:
                    logits, lowp_masks = ref.control_masks(img)
                    low = max(low, *ref.gaps(logits, lowp_masks))
                else:
                    logits = ref.logits(img)
                gap = max(gap, *ref.gaps(logits, mine))
        del ref
        predictlib.free(self.dev)
        return {"numbers": {"mask_gap": gap},
                "detail": {"calls_checked": [call for call, _ in self.sample]},
                "control": {"fp8": {"mask_gap": low}} if control else {}}
