"""Train and eval steps, the composite-loss dispatch and the shared forward
(the port of ``seghiero_tpu/train/steps.py:48-304,374-408``).

The step: forward under bf16 autocast over f32 parameters (``model.dtype:
bfloat16``; f32 runs without autocast), the loss in f32 outside autocast,
backward, the optimizer's update. The triplet schedule follows the global
optimizer step (``training.triplet_schedule_unit: epoch`` uses the epoch
index). ``transform.device_hflip`` flips each sample's image and fine mask
on the card inside the train step (``device_hflip``), and
``training.grad_clip_norm`` clips the gradients before the update.

The JAX package compiles one program per step. On the card the port issues
one too: ``train_step`` captures the whole step (forward, loss, backward,
clip, update) as one CUDA graph and replays it, so the host launches a step
once instead of its thousands of kernels one by one. The step is written so
that it needs no host sync: the losses' tables are made on the card once,
the triplet schedule reads the step from a device scalar, the update reads
each group's learning rate from a device tensor (``train/optim.py``), and
the gradients autograd skips are zeros made once. The graph engages only
where that is sound, which the step checks on every call: parameters on the
card, the same model, composite loss, config and optimizer (its state not
replaced since the capture), and a batch of the captured keys, shapes and
dtypes. The first ``EAGER_CALLS`` calls of a batch signature run eagerly on
a side stream, which warms cuDNN, cuBLAS and attention up and creates the
optimizer's state; the next is captured on that stream and replayed. Any
other call — the CPU, another shape after the capture, a step inside
someone else's capture — runs the same step eagerly.
"""

from __future__ import annotations

import contextlib
import warnings
import weakref
from typing import Dict

import numpy as np
import torch
from torch import nn

from seghiero_torch import ops, trace
from seghiero_torch.config import SegHieroConfig, not_yet_ported
from seghiero_torch.data.pipeline import normalize_images
from seghiero_torch.losses.fast import (
    FastHieraTripletLoss,
    FastRMIHieraTripletLoss,
    aux_ce_fast,
)
from seghiero_torch.ops.resize import resize_bilinear
from seghiero_torch.train.metrics import confusion_matrix, pixel_accuracy_counts
from seghiero_torch.train.optim import clip_grad_global_norm_, device_lrs, write_lrs

# calls of one batch signature that run eagerly before the next is captured
EAGER_CALLS = 2


def make_composite_loss(cfg: SegHieroConfig):
    """The fast-path composite: 3-level (RMI + group triplet) when the
    hierarchy has a super level, else 2-level; every other choice raises.
    As in the JAX package, the 3-level loss takes ``training.fine_weight``
    as its RMI weight λ (and a loss weight of 1), the 2-level one as its
    loss weight."""
    h, t = cfg.hierarchy, cfg.training
    if h.has_super and (t.triplet_upper_ids is None or t.triplet_lower_ids is None):
        upper, lower = h.split_upper_lower()
        if not upper or not lower:
            warnings.warn(
                "the hierarchy-derived triplet upper/lower split is "
                f"one-sided (upper={upper}, lower={lower}): every "
                "non-background fine class falls in one super bucket, "
                "so the tree-triplet term will never activate. Set "
                "training.triplet_upper_ids / training.triplet_lower_ids "
                "explicitly to define the positive/negative groups.",
                stacklevel=2,
            )
    if not t.fast_losses:
        raise not_yet_ported("training.fast_losses: false (the NHWC parity losses)")
    if t.extra_losses:
        raise not_yet_ported("training.extra_losses (dice, lovasz)")
    ohem = (t.ohem_thresh, t.ohem_min_kept * t.batch_size) if t.ohem_thresh is not None else None
    if h.has_super:
        return FastRMIHieraTripletLoss(
            h, rmi_radius=t.rmi_radius, loss_weight_lambda=t.fine_weight, loss_weight=1.0,
            rmi_streaming=t.rmi_streaming, rmi_backend=t.rmi_backend,
            rmi_precision=t.rmi_precision, hiera_variant=t.hiera_variant, ohem=ohem,
            upper_ids=t.triplet_upper_ids, lower_ids=t.triplet_lower_ids,
            selection=t.triplet_selection, use_kernel=t.pallas_fused_loss,
            hiera_precision=t.hiera_precision,
        )
    return FastHieraTripletLoss(
        h, loss_weight=t.fine_weight, use_kernel=t.pallas_fused_loss,
        hiera_variant=t.hiera_variant, ohem=ohem, selection=t.triplet_selection,
        hiera_precision=t.hiera_precision,
    )


def check_step_options(cfg: SegHieroConfig) -> None:
    """Raise for step options the port does not take."""
    if cfg.model.dtype not in ("bfloat16", "float32"):
        raise ValueError(f"model.dtype must be bfloat16 or float32, got {cfg.model.dtype}")


def autocast_for(cfg: SegHieroConfig, device: torch.device, cache: bool = True):
    """bf16 autocast for ``model.dtype: bfloat16``; nothing for f32.
    ``cache=False`` recasts each weight at each use (the same values; a CUDA
    graph's capture keeps no cast across it)."""
    if cfg.model.dtype == "bfloat16":
        return torch.autocast(device_type=device.type, dtype=torch.bfloat16,
                              cache_enabled=cache)
    return contextlib.nullcontext()


def flip_coins(cfg: SegHieroConfig, step: int, batch_size: int, device) -> torch.Tensor:
    """``transform.device_hflip``'s coins of optimizer step ``step``: one
    per sample, true with probability ``hflip_prob``, drawn on ``device``
    by a ``torch.Generator`` seeded from ``(training.seed + 0x5E6, step)``
    — as the JAX step folds that step into the key ``training.seed +
    0x5E6``, though not JAX's PRNG stream: the two packages flip other
    samples. Seeding is host arithmetic; the draw stays on the device (no
    host sync)."""
    seq = np.random.SeedSequence([cfg.training.seed + 0x5E6, int(step)])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seq.generate_state(1, np.uint64)[0]) >> 1)
    return torch.rand(batch_size, generator=gen, device=device) < cfg.transform.hflip_prob


def device_hflip(images: torch.Tensor, fine: torch.Tensor, coins: torch.Tensor):
    """Flip image ``[B, H, W, C]`` and fine mask ``[B, H, W]`` of each
    sample whose coin is true along W: the JAX step's ``jnp.where``."""
    return (torch.where(coins[:, None, None, None], images.flip(2), images),
            torch.where(coins[:, None, None], fine.flip(2), fine))


def flips(cfg: SegHieroConfig) -> bool:
    """Whether the train step flips its batch (``transform.device_hflip``)."""
    return cfg.transform.device_hflip and cfg.transform.hflip_prob > 0


def forward_losses(model: nn.Module, composite, cfg: SegHieroConfig,
                   batch: Dict[str, torch.Tensor], sched_step, flip_step=None,
                   traced: bool = False, *, coins=None, autocast_cache: bool = True):
    """Forward + loss assembly shared by train and eval (the model's mode
    is the caller's). With ``flip_step`` (the train step's optimizer step)
    and ``transform.device_hflip`` on, the batch is flipped first, by the
    ``coins`` given or else those ``flip_coins`` draws. ``sched_step`` is a
    Python int or a device scalar (``triplet_schedule_factor``). Returns
    ``(loss, main_loss, aux_loss, logits)`` with the low-res logits
    ``[B, C, H/4, W/4]`` f32. With ``traced`` (``train_step``'s call) the
    two halves are the spans ``train.forward`` and ``train.loss``; other
    callers record none."""
    with trace.span("train.forward") if traced else trace.OFF:
        images = normalize_images(batch["image"], cfg.transform.normalize_mean,
                                  cfg.transform.normalize_std)
        fine = batch["fine"].to(torch.int32)
        if flip_step is not None and flips(cfg):
            if coins is None:
                coins = flip_coins(cfg, flip_step, images.shape[0], images.device)
            images, fine = device_hflip(images, fine, coins)
        with autocast_for(cfg, images.device, autocast_cache):
            # NHWC viewed as NCHW is the channels_last layout cuDNN wants
            out = model(images.permute(0, 3, 1, 2))
    with trace.span("train.loss") if traced else trace.OFF:
        logits = out["logits"]
        main = composite(sched_step, out["embedding"], logits, logits, fine)
        aux = aux_ce_fast(out["aux_logits"], fine, cfg.hierarchy.ignore_index,
                          hiera_precision=cfg.training.hiera_precision)
        loss = main + cfg.training.aux_weight * aux
    return loss, main, aux, logits


def _signature(batch: Dict[str, torch.Tensor]) -> tuple:
    return tuple(sorted((k, tuple(v.shape), v.dtype, v.device) for k, v in batch.items()))


class _Step:
    """The train step of one optimizer, with what it keeps across calls:
    the zero gradients of the parameters autograd skips (made once); on the
    card, each group's learning rate and the schedule's step as device
    scalars, the side stream, and the captured graph with its static
    inputs, outputs and gradients and the launches its capture counted.
    It holds no reference to the optimizer, which keys it."""

    def __init__(self, model, composite, optimizer, cfg: SegHieroConfig):
        self.owner = (model, composite, cfg)
        self.state, self.groups = optimizer.state, optimizer.param_groups
        self.params = [p for g in self.groups for p in g["params"]]
        self.zeros: Dict[torch.Tensor, torch.Tensor] = {}
        self.cuda = bool(self.params) and all(p.is_cuda for p in self.params)
        self.graph = None
        self.signature, self.calls = None, 0
        if self.cuda:
            dev = self.params[0].device
            self.lrs = [torch.zeros((), dtype=torch.float32, device=dev) for _ in self.groups]
            self.sched = torch.zeros((), dtype=torch.int64, device=dev)
            self.stream = torch.cuda.Stream(dev)

    def serves(self, model, composite, optimizer, cfg) -> bool:
        """Whether this is still the step of these objects: the same ones,
        and the optimizer's state and groups not replaced since."""
        return (self.owner[0] is model and self.owner[1] is composite and self.owner[2] is cfg
                and optimizer.state is self.state and optimizer.param_groups is self.groups)

    def run(self, optimizer, batch, step: int, sched_step: int, scheduler):
        if not self.cuda or torch.cuda.is_current_stream_capturing():
            return self._eager(optimizer, batch, step, sched_step, scheduler)
        sig = _signature(batch)
        if self.graph is None and sig != self.signature:
            self.signature, self.calls = sig, 0
        if sig != self.signature:  # another shape after the capture
            return self._eager(optimizer, batch, step, sched_step, scheduler)
        self.calls += 1
        if self.graph is None and self.calls <= EAGER_CALLS:
            cur = torch.cuda.current_stream()
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                out = self._eager(optimizer, batch, step, sched_step, scheduler)
            cur.wait_stream(self.stream)
            for v in out.values():  # made on the side stream, read on this one
                v.record_stream(cur)
            return out
        return self._replay(optimizer, batch, step, sched_step, scheduler)

    def _zero(self, p: torch.Tensor) -> torch.Tensor:
        z = self.zeros.get(p)
        if z is None:
            z = self.zeros[p] = torch.zeros_like(p)
        return z

    def _update(self, optimizer, batch, flip_step, coins, sched, scheduler=None,
                autocast_cache=True):
        """Forward, loss, backward, update and the schedule's step, the
        gradients set to None before; the losses, detached."""
        model, composite, cfg = self.owner
        loss, main, aux, _ = forward_losses(model, composite, cfg, batch, sched, flip_step,
                                            traced=True, coins=coins,
                                            autocast_cache=autocast_cache)
        with trace.span("train.backward"):
            loss.backward()
        with trace.span("train.optimizer"):
            # every parameter gets a gradient, as in the JAX step: weight
            # decay and momentum apply to all
            for p in self.params:
                if p.grad is None:
                    p.grad = self._zero(p)
            if cfg.training.grad_clip_norm:
                clip_grad_global_norm_(model.parameters(), cfg.training.grad_clip_norm)
            with device_lrs(optimizer, self.lrs) if self.cuda else contextlib.nullcontext():
                optimizer.step()
            if scheduler is not None:
                scheduler.step()
        return {"loss": loss.detach(), "main_loss": main.detach(), "aux_loss": aux.detach()}

    def _write_scalars(self, optimizer, sched_step: int) -> None:
        write_lrs(optimizer, self.lrs)
        self.sched.fill_(sched_step)

    def _eager(self, optimizer, batch, step, sched_step, scheduler):
        if self.cuda:
            self._write_scalars(optimizer, sched_step)
        with trace.span("train.optimizer"):
            optimizer.zero_grad(set_to_none=True)
        return self._update(optimizer, batch, step, None,
                            self.sched if self.cuda else sched_step, scheduler)

    def _capture(self, optimizer, batch, coins) -> None:
        """The step on static inputs, captured on the side stream: nothing
        runs until the graph is replayed. The launch counters move by one
        step's launches here."""
        self.inputs = {k: torch.empty_like(batch[k]) for k in ("image", "fine")}
        self.coins = None if coins is None else torch.empty_like(coins)
        optimizer.zero_grad(set_to_none=True)  # the backward's gradients: the graph's own
        before = ops.counters()
        graph = torch.cuda.CUDAGraph()
        # thread_local: the loader's worker thread may pin memory meanwhile
        with torch.cuda.graph(graph, stream=self.stream, capture_error_mode="thread_local"):
            self.out = self._update(optimizer, self.inputs, 0, self.coins, self.sched,
                                    autocast_cache=False)
        self.launches = {k: n - before[k] for k, n in ops.counters().items() if n != before[k]}
        model = self.owner[0]
        self.grads = [(p, p.grad) for p in model.parameters() if p.grad is not None]
        self.graph = graph

    def _replay(self, optimizer, batch, step, sched_step, scheduler):
        with trace.span("train.replay"):
            cfg = self.owner[2]
            coins = None
            if flips(cfg):
                coins = flip_coins(cfg, step, batch["image"].shape[0], self.params[0].device)
            self._write_scalars(optimizer, sched_step)
            captured = self.graph is None
            if captured:
                self._capture(optimizer, batch, coins)
            for k, t in self.inputs.items():
                t.copy_(batch[k])
            if coins is not None:
                self.coins.copy_(coins)
            self.graph.replay()
            if not captured:  # a replay runs no Python: count what the capture counted
                ops.add_launches(self.launches)
            if self.grads and self.grads[0][0].grad is not self.grads[0][1]:
                for p, g in self.grads:  # an eager step replaced them meanwhile
                    p.grad = g
            out = {k: v.clone() for k, v in self.out.items()}
            if scheduler is not None:
                scheduler.step()
        return out


# each optimizer's step, dropped with the optimizer
_steps: "weakref.WeakKeyDictionary[torch.optim.Optimizer, _Step]" = weakref.WeakKeyDictionary()


def forget_step_graph(optimizer: torch.optim.Optimizer) -> None:
    """Drop what ``train_step`` keeps for ``optimizer`` (its CUDA graph
    among it): the next calls warm up and capture anew. For whoever
    replaces the optimizer's state or the parameters' storage in place
    (``CheckpointManager.restore`` calls it)."""
    _steps.pop(optimizer, None)


def train_step(model: nn.Module, composite, optimizer: torch.optim.Optimizer,
               cfg: SegHieroConfig, batch: Dict[str, torch.Tensor], step: int,
               epoch: int = 0, scheduler=None) -> Dict[str, torch.Tensor]:
    """One update. ``step`` is the global optimizer step before this
    update. Every parameter gets a gradient — a zero one where the graph
    gives none — so weight decay and momentum apply to all, as in the JAX
    step. Returns the step's losses as device scalars of their own (no host
    sync). On the card the step is a CUDA graph's replay once warm (the
    module's docstring). The span ``train.step`` holds, in an eager step,
    ``train.forward``, ``train.loss``, ``train.backward`` and
    ``train.optimizer`` (entered for the gradients' reset, the update and
    the schedule's step); in a replayed one, ``train.replay``."""
    with trace.span("train.step"):
        model.train()
        sched_step = step if cfg.training.triplet_schedule_unit == "step" else epoch
        runner = _steps.get(optimizer)
        if runner is None or not runner.serves(model, composite, optimizer, cfg):
            runner = _steps[optimizer] = _Step(model, composite, optimizer, cfg)
        return runner.run(optimizer, batch, step, sched_step, scheduler)


@torch.no_grad()
def eval_step(model: nn.Module, composite, cfg: SegHieroConfig,
              batch: Dict[str, torch.Tensor], step: int) -> Dict:
    """Loss, and per level the pixel-accuracy counts and confusion matrix
    of the argmax of the bilinearly upsampled logits (device tensors)."""
    model.eval()
    h = cfg.hierarchy
    loss, _, _, logits = forward_losses(model, composite, cfg, batch, step)
    H, W = batch["fine"].shape[1:3]
    up = resize_bilinear(logits.to(torch.float32).contiguous(), (H, W))
    labels = {"fine": batch["fine"], "coarse": batch.get("coarse")}
    if h.has_super:
        labels["super"] = batch.get("super")
    stats = {}
    for lvl, (lo, hi) in zip(labels, h.level_slices):
        pred = up[:, lo:hi].argmax(dim=1)
        target = labels[lvl].to(pred.dtype)
        correct, valid = pixel_accuracy_counts(pred, target, h.ignore_index)
        stats[lvl] = {"correct": correct, "valid": valid,
                      "cm": confusion_matrix(pred, target, hi - lo, h.ignore_index)}
    return {"loss": loss, "levels": stats}
