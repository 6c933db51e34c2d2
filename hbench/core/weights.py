"""Weights from the seed, on the device, in a few large calls: one normal
draw for every weight of two or more dimensions (then scaled to
lecun-normal, std 1/√fan_in) and every bias and norm shift (std 0.1), one
uniform draw for the norm scales (0.5–1.5). The last layer of each
residual branch, named by the reference module's ``RESIDUAL_LAST``
fragments, is drawn at a tenth: its scales or, where no norm follows it,
its weights (ResNet's ``bn3``, after torchvision's ``zero_init_residual``:
at 1.0 the random 100-layer net is chaotic, a one-level change of an input
pixel moving its logits by half their spread, and no comparison could
tell bf16 from fp8). Running statistics start at 0 / 1; ``calibrate_``
sets them from one train-mode pass (momentum 1) over seeded images, so
activations keep a realistic scale through 100 layers in eval mode. The
state dict uses the reference checkpoint's names and loads into the
reference model and the program's alike."""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
from torch import nn

from hbench.core import scene
from hbench.reference.train import normalize

RESIDUAL_GAIN = 0.1


def make(model: nn.Module, seed: int, device,
         residual_last: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """A state dict for ``model`` (built on the meta device) from ``seed``;
    the scales and weights whose names hold a fragment of
    ``residual_last`` at a tenth."""
    gen = scene.generator(seed, device, stream=17)
    sd = {k: v for k, v in model.state_dict().items()}
    normal = [k for k, v in sd.items() if v.is_floating_point()
              and not k.endswith(("running_mean", "running_var"))
              and not (k.endswith(".weight") and v.ndim == 1)]
    scales = [k for k, v in sd.items() if k.endswith(".weight") and v.ndim == 1]
    z = torch.randn(sum(sd[k].numel() for k in normal), generator=gen, device=device)
    u = torch.rand(sum(sd[k].numel() for k in scales), generator=gen, device=device)

    def gain(k):
        return RESIDUAL_GAIN if any(f in k for f in residual_last) else 1.0

    out, i = {}, 0
    for k in normal:
        n = sd[k].numel()
        std = gain(k) / math.sqrt(sd[k][0].numel()) if sd[k].ndim >= 2 else 0.1
        out[k] = (z[i:i + n] * std).view(sd[k].shape)
        i += n
    i = 0
    for k in scales:
        n = sd[k].numel()
        out[k] = (u[i:i + n] + 0.5).view(sd[k].shape) * gain(k)
        i += n
    for k, v in sd.items():
        if k.endswith("running_mean"):
            out[k] = torch.zeros(v.shape, device=device)
        elif k.endswith("running_var"):
            out[k] = torch.ones(v.shape, device=device)
        elif k not in out:
            out[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
    return out


def materialize(model: nn.Module, sd: Dict[str, torch.Tensor], device) -> nn.Module:
    """The meta-device reference model on ``device`` holding ``sd``."""
    model = model.to_empty(device=device)
    model.load_state_dict(sd, strict=True)
    return model


@torch.no_grad()
def calibrate_(model: nn.Module, sd: Dict[str, torch.Tensor], seed: int, n_classes: int,
               transform: Dict, hw=(256, 256), n: int = 2) -> Dict[str, torch.Tensor]:
    """Set ``sd``'s BatchNorm running statistics from one train-mode pass
    of the reference model (holding ``sd``) over ``n`` seeded scenes."""
    device = next(iter(sd.values())).device
    imgs, _ = scene.scenes(scene.generator(seed, device, stream=23), n, hw, n_classes)
    bns = [m for m in model.modules() if hasattr(m, "running_var")]
    for m in bns:
        m.momentum = 1.0
    model.train()
    model(normalize(imgs, transform), with_train_heads=False)
    for m in bns:
        m.momentum = 0.1
    model.eval()
    new = model.state_dict()
    return {k: (new[k].detach().clone() if k.endswith(("running_mean", "running_var")) else v)
            for k, v in sd.items()}
