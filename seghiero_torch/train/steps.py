"""Train and eval steps, the composite-loss dispatch and the shared forward
(the port of ``seghiero_tpu/train/steps.py:48-304,374-408``).

The JAX package compiles one program per step; here the step runs eagerly:
forward under bf16 autocast over f32 parameters (``model.dtype:
bfloat16``; f32 runs without autocast), the loss in f32 outside autocast,
backward, SGD update. The triplet schedule follows the global optimizer
step (``training.triplet_schedule_unit: epoch`` uses the epoch index).
``transform.device_hflip`` flips each sample's image and fine mask on the
card inside the train step (``device_hflip``), and
``training.grad_clip_norm`` clips the gradients before the update.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Dict

import numpy as np
import torch
from torch import nn

from seghiero_torch import trace
from seghiero_torch.config import SegHieroConfig
from seghiero_torch.data.pipeline import normalize_images
from seghiero_torch.losses.fast import (
    FastHieraTripletLoss,
    FastRMIHieraTripletLoss,
    aux_ce_fast,
)
from seghiero_torch.ops.resize import resize_bilinear
from seghiero_torch.train.metrics import confusion_matrix, pixel_accuracy_counts
from seghiero_torch.train.optim import clip_grad_global_norm_


def _not_yet_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to seghiero_torch (ROADMAP queue 1)")


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
        raise _not_yet_ported("training.fast_losses: false (the NHWC parity losses)")
    if t.extra_losses:
        raise _not_yet_ported("training.extra_losses (dice, lovasz)")
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


def autocast_for(cfg: SegHieroConfig, device: torch.device):
    """bf16 autocast for ``model.dtype: bfloat16``; nothing for f32."""
    if cfg.model.dtype == "bfloat16":
        return torch.autocast(device_type=device.type, dtype=torch.bfloat16)
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


def forward_losses(model: nn.Module, composite, cfg: SegHieroConfig,
                   batch: Dict[str, torch.Tensor], sched_step, flip_step=None,
                   traced: bool = False):
    """Forward + loss assembly shared by train and eval (the model's mode
    is the caller's). With ``flip_step`` (the train step's optimizer step)
    and ``transform.device_hflip`` on, the batch is flipped first. Returns
    ``(loss, main_loss, aux_loss, logits)`` with the low-res logits
    ``[B, C, H/4, W/4]`` f32. With ``traced`` (``train_step``'s call) the
    two halves are the spans ``train.forward`` and ``train.loss``; other
    callers record none."""
    with trace.span("train.forward") if traced else trace.OFF:
        images = normalize_images(batch["image"], cfg.transform.normalize_mean,
                                  cfg.transform.normalize_std)
        fine = batch["fine"].to(torch.int32)
        tf = cfg.transform
        if flip_step is not None and tf.device_hflip and tf.hflip_prob > 0:
            coins = flip_coins(cfg, flip_step, images.shape[0], images.device)
            images, fine = device_hflip(images, fine, coins)
        with autocast_for(cfg, images.device):
            # NHWC viewed as NCHW is the channels_last layout cuDNN wants
            out = model(images.permute(0, 3, 1, 2))
    with trace.span("train.loss") if traced else trace.OFF:
        logits = out["logits"]
        main = composite(sched_step, out["embedding"], logits, logits, fine)
        aux = aux_ce_fast(out["aux_logits"], fine, cfg.hierarchy.ignore_index,
                          hiera_precision=cfg.training.hiera_precision)
        loss = main + cfg.training.aux_weight * aux
    return loss, main, aux, logits


def train_step(model: nn.Module, composite, optimizer: torch.optim.Optimizer,
               cfg: SegHieroConfig, batch: Dict[str, torch.Tensor], step: int,
               epoch: int = 0, scheduler=None) -> Dict[str, torch.Tensor]:
    """One SGD update. ``step`` is the global optimizer step before this
    update. Every parameter gets a gradient — a zero one where the graph
    gives none — so weight decay and momentum apply to all, as in the JAX
    step. Returns the step's losses as device scalars (no host sync). The
    span ``train.step`` holds ``train.forward``, ``train.loss``,
    ``train.backward`` and ``train.optimizer`` (entered twice: the
    gradients' reset, then the update)."""
    with trace.span("train.step"):
        model.train()
        sched_step = step if cfg.training.triplet_schedule_unit == "step" else epoch
        with trace.span("train.optimizer"):
            optimizer.zero_grad(set_to_none=True)
        loss, main, aux, _ = forward_losses(model, composite, cfg, batch, sched_step,
                                            flip_step=step, traced=True)
        with trace.span("train.backward"):
            loss.backward()
        with trace.span("train.optimizer"):
            for group in optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            if cfg.training.grad_clip_norm:
                clip_grad_global_norm_(model.parameters(), cfg.training.grad_clip_norm)
            optimizer.step()
            if scheduler is not None:
                scheduler.step()
        out = {"loss": loss.detach(), "main_loss": main.detach(), "aux_loss": aux.detach()}
        del loss, main, aux, _  # the autograd graph's teardown, inside the step's span
    return out


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
