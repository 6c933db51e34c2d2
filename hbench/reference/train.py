"""The reference's training steps: the plain model and losses in float32
(TF32 off), on the batches the program's first steps took, with the
optimizer's update written out in ``reference/optim/<name>.py``
(``update(params, grads, state, training, step)``, found by the program
config's ``training.optimizer``). Returns what the comparison reads: each
step's loss, the first step's gradients as the optimizer takes them (after
the global norm clip, before weight decay), and each parameter's change
after the steps."""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

import torch

from hbench.reference.losses import total_loss
from hbench.reference.tree import Tree

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(images_u8: torch.Tensor, transform: Dict) -> torch.Tensor:
    """uint8 NHWC → f32 NCHW, ``(x − 255·mean) / (255·std)``."""
    mean = torch.tensor(transform.get("normalize_mean", IMAGENET_MEAN),
                        device=images_u8.device) * 255.0
    std = torch.tensor(transform.get("normalize_std", IMAGENET_STD),
                       device=images_u8.device) * 255.0
    return ((images_u8.float() - mean) / std).permute(0, 3, 1, 2)


def param_setting(name: str, p: torch.Tensor, training: Dict):
    """(learning rate, weight decay) of a parameter: the backbone at
    ``lr · backbone_lr_scale``; with ``wd_skip_norm_bias`` decay on the
    weights of two or more dimensions only (convolutions and linear
    layers), as the program's ``param_groups``."""
    lr = float(training.get("lr", 1e-3))
    if name.startswith("backbone."):
        lr *= float(training.get("backbone_lr_scale", 1.0))
    wd = float(training.get("weight_decay", 1e-4))
    if training.get("wd_skip_norm_bias") and p.ndim < 2:
        wd = 0.0
    return lr, wd


def fast_stores(training: Dict) -> Dict[str, bool]:
    """Where the configuration stores bf16 in the loss: the upsampled logits
    under ``hiera_precision: fast`` (the default, but for the fused loss
    kernels, which take f32) and RMI's maps under ``rmi_precision: fast``."""
    hiera = training.get("hiera_precision") or (
        "parity" if training.get("pallas_fused_loss") else "fast")
    return {"low_logits": hiera == "fast",
            "low_rmi": training.get("rmi_precision", "parity") == "fast"}


def train_steps(model: torch.nn.Module, update: Callable, training: Dict, transform: Dict,
                tree: Tree, batches: List[Dict[str, torch.Tensor]],
                coins: Optional[Callable[[int, int], torch.Tensor]] = None,
                forward=contextlib.nullcontext):
    """Run ``len(batches)`` steps from the model's parameters: forward,
    loss, backward and the global norm clip here, the parameters' update
    by ``update(params, grads, state, training, step)`` (an optimizer's
    module under ``reference/optim/``). ``coins`` gives the flip of each
    sample of a step (``transform.device_hflip``); ``forward`` is entered
    around the model's forward pass alone (a bf16 autocast makes the bf16
    witness of ``PERF.md``). Returns ``(losses, first_grads, changes,
    first_logits)``, the middle two by name."""
    model.train()
    params = dict(model.named_parameters())
    p0 = {k: v.detach().clone() for k, v in params.items()}
    clip = training.get("grad_clip_norm")
    state: Dict = {}
    losses, first, first_logits = [], None, None
    for step, batch in enumerate(batches):
        images, fine = batch["image"], batch["fine"].long()
        if coins is not None:
            c = coins(step, images.shape[0])
            images = torch.where(c[:, None, None, None], images.flip(2), images)
            fine = torch.where(c[:, None, None], fine.flip(2), fine)
        model.zero_grad(set_to_none=True)
        with forward():
            out = model(normalize(images, transform))
        if step == 0:
            first_logits = out["logits"].detach().float().clone()
        loss = total_loss(out, fine, tree, step,
                          float(training.get("fine_weight", 1.0)), **fast_stores(training))
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        if clip:
            norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
            scale = float(clip) / max(float(norm), float(clip))
            grads = {k: g * scale for k, g in grads.items()}
        if step == 0:
            first = {k: g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            update(params, grads, state, training, step)
        losses.append(float(loss.detach()))
    changes = {k: (p.detach() - p0[k]) for k, p in params.items()}
    return losses, first, changes, first_logits
