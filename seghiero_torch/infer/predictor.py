"""Inference engine: reference-checkpoint restore + batched per-level
prediction (the port of the masks-only path of
``seghiero_tpu/infer/predictor.py``).

normalize (on the device) → backbone → decode head (logits only) →
C-major logits → 4× upsample + per-level argmax. With
``model.argmax_backend: pallas`` an exact 4× output goes through the
fused kernel (``ops/upsample_argmax.py``); any other output size, and
``xla``, goes through ``F.interpolate`` + ``argmax``.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from seghiero_torch.config import SegHieroConfig
from seghiero_torch.data.pipeline import normalize_images
from seghiero_torch.models.convert import load_reference_checkpoint
from seghiero_torch.models.segmenter import build_model
from seghiero_torch.ops.resize import resize_bilinear
from seghiero_torch.ops.upsample_argmax import upsample_argmax

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is wanted and no card is visible — the port
    never carries on on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the CPU"
        )
    return dev


def prepare_model(model: nn.Module, dtype: torch.dtype, device: torch.device) -> nn.Module:
    """Eval mode on ``device``: convolutions in the compute dtype,
    BatchNorm parameters and statistics kept in f32 (BN computes in f32 and
    rounds its output to the input dtype, as the JAX package does). On
    CUDA the convolutions' weights are channels_last, the layout cuDNN and
    the depthwise kernel take."""
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            mod.to(dtype)
    model.eval()
    if device.type == "cuda":
        return model.to(device, memory_format=torch.channels_last)
    return model.to(device)


def decode_masks(lo: torch.Tensor, out_hw: Tuple[int, int],
                 level_slices: Mapping[str, Tuple[int, int]],
                 backend: str = "xla") -> Dict[str, torch.Tensor]:
    """C-major logits ``[B, C, h, w]`` → per-level int32 masks
    ``[B, *out_hw]``: the fused kernel for ``pallas`` and an exact 4×
    output, else ``F.interpolate`` + ``argmax`` (first maximum wins)."""
    B, C, h, w = lo.shape
    if backend == "pallas" and tuple(out_hw) == (4 * h, 4 * w):
        names = list(level_slices)
        outs = upsample_argmax(lo, [level_slices[n] for n in names])
        return dict(zip(names, outs))
    up = resize_bilinear(lo, out_hw)
    return {
        lvl: up[:, a:b].argmax(dim=1).to(torch.int32)
        for lvl, (a, b) in level_slices.items()
    }


class Predictor:
    """``Predictor(cfg, checkpoint_dict, device)``: ``checkpoint_dict`` is a
    reference-layout checkpoint (``backbone_state_dict`` /
    ``aspp_head_state_dict`` / ``aux_head_state_dict``), e.g. the output of
    ``models.convert.export_reference_checkpoint``; None keeps the
    constructor's initial weights."""

    def __init__(self, cfg: SegHieroConfig, state_dict: Optional[Mapping] = None,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.model.dtype]
        model = build_model(cfg)
        if state_dict is not None:
            load_reference_checkpoint(model, state_dict)
        self.model = prepare_model(model, self.dtype, self.device)
        h = cfg.hierarchy
        self.level_slices = dict(zip(("fine", "coarse", "super"), h.level_slices))
        luts = {"coarse": h.fine_to_coarse}
        if h.has_super:
            luts["super"] = h.fine_to_super
        self._luts = {
            k: torch.as_tensor(np.asarray(v, np.int64), device=self.device)
            for k, v in luts.items()
        }

    @classmethod
    def from_checkpoint(cls, cfg: SegHieroConfig, checkpoint: Optional[str] = None,
                        device: Union[str, torch.device, None] = None) -> "Predictor":
        """``checkpoint``: a reference-layout ``.pth`` / ``.pt`` file (what
        the original SegHiero saves and
        ``seghiero_tpu.models.torch_convert.export_reference_checkpoint``
        writes)."""
        if not checkpoint or not checkpoint.endswith((".pth", ".pt")):
            raise ValueError(
                f"seghiero_torch reads reference-layout .pth/.pt checkpoints only, "
                f"got {checkpoint!r}. Orbax checkpoint directories are the JAX "
                "package's format: convert one with "
                "seghiero_tpu.models.torch_convert.export_reference_checkpoint "
                "and torch.save the result"
            )
        if os.path.isdir(checkpoint) or not os.path.exists(checkpoint):
            raise FileNotFoundError(f"no checkpoint file at {checkpoint}")
        ckpt = torch.load(checkpoint, map_location="cpu", weights_only=True)
        return cls(cfg, ckpt, device)

    # ------------------------------------------------------------------
    def logits(self, images_u8: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        """uint8 NHWC images → C-major f32 logits ``[B, C, H/4, W/4]`` on
        the device (contiguous: the decode kernel's layout)."""
        if isinstance(images_u8, np.ndarray):  # torch wants a writable buffer
            images_u8 = torch.from_numpy(np.require(images_u8, np.uint8, ("C", "W")))
        x = images_u8.to(self.device, non_blocking=True)
        x = normalize_images(
            x, self.cfg.transform.normalize_mean, self.cfg.transform.normalize_std
        )
        # NHWC viewed as NCHW is the channels_last layout cuDNN wants
        out = self.model(x.permute(0, 3, 1, 2), outputs=("logits",))
        return out["logits"].contiguous()

    def predict_masks(self, images_u8: Union[np.ndarray, torch.Tensor],
                      out_hw: Optional[Tuple[int, int]] = None,
                      consistent: bool = False) -> Dict[str, torch.Tensor]:
        """Masks-only prediction; the masks stay on the device.
        ``consistent=True`` derives coarse/super from the fine argmax
        through the hierarchy LUTs (tree-consistent labels)."""
        out_hw = tuple(out_hw or tuple(images_u8.shape[1:3]))
        with torch.inference_mode():
            masks = decode_masks(self.logits(images_u8), out_hw, self.level_slices,
                                 self.cfg.model.argmax_backend)
            if consistent:
                fine = masks["fine"].long()
                for lvl, lut in self._luts.items():
                    masks[lvl] = lut[fine].to(torch.int32)
        return masks

    def predict_array(self, images_u8: np.ndarray,
                      out_hw: Optional[Tuple[int, int]] = None,
                      consistent: bool = False) -> Dict[str, np.ndarray]:
        """images_u8 [B, H, W, 3] → per-level int32 masks [B, out_h, out_w]
        (out defaults to the input size). ``consistent=False`` decodes each
        level by its own argmax, as the reference does."""
        masks = self.predict_masks(images_u8, out_hw, consistent)
        return {k: v.cpu().numpy() for k, v in masks.items()}
