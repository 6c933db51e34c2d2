"""The training cells' common driver: the program's ``train_step`` on a
feed of batches, as ``train/loop.py`` ``fit`` calls it.

Set-up builds one model, loss and optimizer (the program's
``build_model``, ``make_composite_loss``, ``make_optimizer``) holding the
harness's seeded weights, and runs the first three steps through the
window's own call and feed: they warm every shape up, and their readings
(each loss, the first gradient as the optimizer took it, each parameter's
change after the three) are what the reference is held to after the
window. The window then carries on with the same objects. The reference
is the configuration's own model (``ctx.reference``) with the update of
its ``training.optimizer`` (``reference/optim/<name>.py``).
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import Dict, Iterator, List

import numpy as np
import torch

from hbench.core import flops, geometry, syncs, weights
from hbench.reference import compare, lowp
from hbench.reference.train import train_steps

PRE_STEPS = 3


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def flip_coins(seed: int, step: int, batch: int, prob: float, device) -> torch.Tensor:
    """The flips ``transform.device_hflip`` draws at optimizer step ``step``
    of a run whose ``training.seed`` is ``seed``: a generator on the device
    seeded from ``SeedSequence([seed + 0x5E6, step])``, one uniform a sample."""
    seq = np.random.SeedSequence([int(seed) + 0x5E6, int(step)])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seq.generate_state(1, np.uint64)[0]) >> 1)
    return torch.rand(batch, generator=gen, device=device) < prob


class TrainDriver:
    kind = "train"

    def __init__(self, ctx):
        self.ctx = ctx
        self.dev = torch.device(ctx.device)
        self.port = ctx.port_config("train")
        self.batch_size = int(self.port["training"]["batch_size"])
        self.hw = tuple(self.port["transform"]["resize"])

    # -- the feed: subclasses --------------------------------------------
    def make_feed(self) -> Iterator[Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def next_batch(self) -> Dict[str, torch.Tensor]:
        return next(self.feed)

    def close_feed(self) -> None:
        pass

    # -- program -----------------------------------------------------------
    def setup(self) -> None:
        from seghiero_torch.config import SegHieroConfig
        from seghiero_torch.models.segmenter import build_model
        from seghiero_torch.train.optim import make_optimizer, make_schedule
        from seghiero_torch.train.steps import check_step_options, make_composite_loss

        c = self.ctx
        self.cfg = cfg = SegHieroConfig.from_dict(self.port)
        check_step_options(cfg)
        sd = self._weights()
        with torch.device(self.dev):
            model = build_model(cfg)
        if self.dev.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        model.load_state_dict(sd, strict=True)
        self.model = model
        self.composite = make_composite_loss(cfg)
        self.optimizer = make_optimizer(cfg.training, model)
        self.scheduler = make_schedule(cfg.training, 10**9, self.optimizer)
        self.step = 0
        self.feed = self.make_feed()
        if c.trace:  # the kernel counts' reference pass, before the traced segment
            self.unit = geometry.unit(self.batch_size, self.hw, c.tree, c.reference,
                                      self.port["model"], train=True)
        names = {id(p): n for n, p in model.named_parameters()}
        self.kept, losses, seen = [], [], []
        hook = model.register_forward_hook(
            lambda m, args, out: seen.append(out["logits"].detach().float().clone())
            if not seen else None)

        taken = {names[id(p)]: p for g in self.optimizer.param_groups for p in g["params"]}
        first = {}  # the gradients the optimizer's first step takes, after the clip

        def first_grads(optimizer, args, kwargs):
            first.update({n: p.grad.detach().clone() for n, p in taken.items()
                          if p.grad is not None})

        pre = self.optimizer.register_step_pre_hook(first_grads)
        for s in range(PRE_STEPS):
            batch = self.next_batch()
            self.kept.append({k: batch[k].clone() for k in ("image", "fine")})
            losses.append(self._step(batch)["loss"])
            if s == 0:
                hook.remove()
                pre.remove()
                self.logits = seen[0]
                # a step that never reached the optimizer took no gradient
                self.grad_norms = _norms({n: first[n] if n in first else torch.zeros_like(p)
                                          for n, p in taken.items()})
                del first
        self.change_norms = _norms({n: p.detach() - sd[n] for n, p in model.named_parameters()})
        self.losses = [float(x) for x in losses]
        del sd

    def _weights(self):
        c = self.ctx
        return weights.make(c.reference.build(self.port["model"], c.tree), c.seed, self.dev,
                            c.reference.RESIDUAL_LAST)

    def _step(self, batch):
        from seghiero_torch.train.steps import train_step

        m = train_step(self.model, self.composite, self.optimizer, self.cfg, batch,
                       self.step, 0, self.scheduler)
        self.step += 1
        return m

    def window(self, seconds: float) -> Dict:
        spans = self.ctx.spans
        t0 = time.perf_counter()
        n, last = 0, None
        while True:
            batch = self.next_batch()
            with spans.span("step"):
                last = self._step(batch)
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.dev)
        dt = time.perf_counter() - t0
        ok = math.isfinite(float(last["loss"]))
        return {"metrics": {"train_images_per_s": n * self.batch_size / dt},
                "attempted": n, "failed": 0 if ok else n, "units": n, "seconds": dt}

    def segment(self, steps: int) -> List[Dict]:
        """``steps`` more steps, for the profiler; their geometry after."""
        fines = []
        for _ in range(steps):
            batch = self.next_batch()
            with self.ctx.spans.span("step"):
                self._step(batch)
            fines.append(batch["fine"])
        sync(self.dev)
        return [dict(self.unit, valid=int((f != 255).sum())) for f in fines]

    def trace_extras(self) -> Dict:
        n, where = syncs.audit(lambda: self._step(self.next_batch()))
        fl = flops.per_image(self.ctx.reference.build(self.port["model"], self.ctx.tree), self.hw,
                             True)
        return {"host_syncs": n, "host_sync_lines": where, "flops_per_image": fl}

    def release(self) -> None:
        self.close_feed()
        del self.model, self.optimizer, self.composite, self.feed
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- reference -----------------------------------------------------------
    def _reference(self, sd, batches, precision=None, forward=contextlib.nullcontext,
                   training=None):
        c = self.ctx
        tr = self.port["transform"]
        training = training or self.port["training"]
        update = c.bench.optimizer(training.get("optimizer", "sgd")).update
        model = weights.materialize(c.reference.build(self.port["model"], c.tree), sd, self.dev)
        coins = None
        if tr.get("device_hflip") and float(tr.get("hflip_prob", 0.5)) > 0:
            seed, prob = int(self.port["training"]["seed"]), float(tr.get("hflip_prob", 0.5))

            def coins(step, b):
                return flip_coins(seed, step, b, prob, self.dev)
        ctx = lowp.fp8() if precision == "fp8" else contextlib.nullcontext()
        with ctx:
            losses, first, changes, logits = train_steps(model, update, training, tr, c.tree,
                                                         batches, coins, forward)
        out = {"losses": losses, "grad_norms": _norms(first), "change_norms": _norms(changes),
               "logits": logits}
        del model, first, changes
        return out

    def check(self, control: bool = False) -> Dict:
        sd = self._weights()
        prog = {"losses": self.losses, "grad_norms": self.grad_norms,
                "change_norms": self.change_norms, "logits": self.logits}
        with full_fp32():
            ref = self._reference(sd, self.kept)
            numbers = compare.train_numbers(prog, ref)
            readings = {}
            if control:
                half = [{k: v[: max(1, v.shape[0] // 2)] for k, v in b.items()}
                        for b in self.kept]
                readings["fp8"] = compare.train_numbers(self._reference(sd, self.kept, "fp8"), ref)
                try:
                    readings["half_batch"] = compare.train_numbers(self._reference(sd, half),
                                                                   ref)
                except ValueError as e:  # one image a batch: train-mode BN of the pool
                    readings["half_batch"] = {"crashed": str(e)[:200]}
                # a step that leaves its state unchanged: no optimizer state
                # (a zero first gradient), no change, each loss at the start
                still = self._reference(sd, self.kept, training=dict(self.port["training"], lr=0.0))
                still.update(grad_norms={k: 0.0 for k in still["grad_norms"]},
                             change_norms={k: 0.0 for k in still["change_norms"]})
                readings["unchanged"] = compare.train_numbers(still, ref)
                # a second witness, no control: the reference with a bf16
                # forward pass and bf16 stores, as the configuration computes
                with lowp.bf16_stores():
                    readings["bf16_witness"] = compare.train_numbers(self._reference(
                        sd, self.kept,
                        forward=lambda: torch.autocast(self.dev.type, torch.bfloat16)), ref)
        keys = ("loss_gap", "loss_gap_first", "loss_gap_median", "logits_gap", "grad_gap",
                "change_gap")
        return {"numbers": {k: numbers[k] for k in keys},
                "detail": {k: v for k, v in numbers.items() if k not in keys},
                "control": readings}


def _norms(d) -> Dict[str, float]:
    names = list(d)
    if not names:
        return {}
    vals = torch.stack([d[k].detach().double().norm() for k in names]).cpu().tolist()
    return dict(zip(names, vals))


class full_fp32:
    """Full float32 matrix products and convolutions (no TF32) inside."""

    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *a):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.prev
        return False

