"""Inference engine (the port of ``seghiero_tpu/infer/predictor.py``):
checkpoint restore, batched per-level prediction, sliding-window and
test-time-augmented prediction, and mask export.

normalize (on the device) → backbone → decode head (logits only) →
C-major logits → 4× upsample + per-level argmax. With
``model.argmax_backend: pallas`` an exact 4× output goes through the
fused kernel (``ops/upsample_argmax.py``); any other output size, and
``xla``, goes through ``F.interpolate`` + ``argmax``. The sliding window
and TTA need the full-resolution logits, so they always take the
second route, as the JAX package's do. Everything runs eagerly: the image
is copied to the device once, and only the int32 masks come back.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from PIL import Image
from torch import nn

from seghiero_torch import trace
from seghiero_torch.config import SegHieroConfig
from seghiero_torch.data.pipeline import normalize_images
from seghiero_torch.infer.viz import (
    create_colormap,
    draw_class_indices,
    mask_to_color_image,
    save_mask,
)
from seghiero_torch.models.convert import load_reference_checkpoint
from seghiero_torch.models.segmenter import build_model
from seghiero_torch.ops.resize import resize_bilinear
from seghiero_torch.ops.upsample_argmax import upsample_argmax

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def preprocess_image(path: str, resize: Optional[Tuple[int, int]]):
    """PIL load + optional bilinear resize to ``resize`` = (H, W); returns
    (uint8 HWC, the original (H, W), the PIL image). The image stays uint8:
    it is normalized on the device."""
    img = Image.open(path).convert("RGB")
    orig_w, orig_h = img.size
    if resize is not None:
        h, w = resize
        img = img.resize((w, h), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8), (orig_h, orig_w), img


def find_checkpoint(cfg: SegHieroConfig, checkpoint: Optional[str] = None) -> str:
    """The reference-layout model file that ``checkpoint`` names:

    * a ``.pth`` / ``.pt`` file, as it is;
    * a step directory of the port's trainer (``step_NNNNNNNN/model.pth``,
      ``train/checkpoint.py``);
    * a project directory (holds ``best.json`` or ``step_*``): its best
      step, else its latest;
    * the ``output.checkpoint_dir`` root: the same in its ``project_name``;
    * None: the project directory the config names.

    A directory that is none of these raises ``FileNotFoundError``; an
    Orbax step directory of the JAX package (holds ``state/``) raises
    ``ValueError`` with the way to convert it."""
    # imported here: seghiero_torch.train imports this module (resolve_device)
    from seghiero_torch.train.checkpoint import MODEL_FILE, best_model_file

    if checkpoint and checkpoint.endswith((".pth", ".pt")):
        if not os.path.isfile(checkpoint):
            raise FileNotFoundError(f"no checkpoint file at {checkpoint}")
        return checkpoint
    if not checkpoint:
        root = os.path.join(cfg.output.checkpoint_dir, cfg.output.project_name)
    elif os.path.isdir(os.path.join(checkpoint, "state")):
        raise ValueError(
            f"{checkpoint} is an Orbax checkpoint directory, the JAX package's "
            "format; seghiero_torch reads reference-layout .pth/.pt files and its "
            "own checkpoint directories. Convert it with "
            "seghiero_tpu.models.torch_convert.export_reference_checkpoint and "
            "torch.save the result"
        )
    elif os.path.isfile(os.path.join(checkpoint, MODEL_FILE)):
        return os.path.join(checkpoint, MODEL_FILE)
    else:
        entries = os.listdir(checkpoint) if os.path.isdir(checkpoint) else []
        if "best.json" in entries or any(e.startswith("step_") for e in entries):
            root = checkpoint
        elif cfg.output.project_name in entries:
            root = os.path.join(checkpoint, cfg.output.project_name)
        else:
            raise FileNotFoundError(
                f"no checkpoint at {checkpoint}: not a model file, a step directory, "
                f"a project directory or a checkpoint_dir holding {cfg.output.project_name!r}"
            )
    found = best_model_file(root)
    if found is None:
        raise FileNotFoundError(f"No checkpoint found under {root}; pass --checkpoint")
    return found


def window_starts(total: int, win: int, step: int) -> List[int]:
    """Offsets of the windows along one axis: every ``step`` pixels, and a
    last one flush with the edge."""
    s = list(range(0, max(total - win, 0) + 1, step))
    if s[-1] != total - win:
        s.append(total - win)
    return s


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
    """Eval mode on ``device``: convolutions, deconvolutions and linear
    layers in the compute dtype, BatchNorm and LayerNorm parameters (and
    BN's statistics) kept in f32 (both normalize in f32 and round their
    output to the input dtype, as the JAX package does). On CUDA the convolutions' weights are
    channels_last, the layout cuDNN and the depthwise kernel take."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
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
        writes), a checkpoint directory of the port's trainer, or None for
        the best checkpoint of the config's project (``find_checkpoint``)."""
        device = resolve_device(device)  # no card is reported before a missing file
        path = find_checkpoint(cfg, checkpoint)
        return cls(cfg, torch.load(path, map_location="cpu", weights_only=True), device)

    # ------------------------------------------------------------------
    def _to_device(self, images_u8: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        if isinstance(images_u8, np.ndarray):  # torch wants a writable buffer
            images_u8 = torch.from_numpy(np.require(images_u8, np.uint8, ("C", "W")))
        return images_u8.to(self.device, non_blocking=True)

    def _normalize(self, images_u8: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC on the device → f32 NCHW in the channels_last layout
        (cuDNN's and the depthwise kernel's)."""
        x = normalize_images(
            images_u8, self.cfg.transform.normalize_mean, self.cfg.transform.normalize_std
        )
        return x.permute(0, 3, 1, 2)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """Normalized f32 NCHW images → C-major f32 logits ``[B, C, H/4,
        W/4]`` (contiguous: the decode kernel's layout)."""
        x = x.contiguous(memory_format=torch.channels_last)
        return self.model(x, outputs=("logits",))["logits"].contiguous()

    def logits(self, images_u8: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        """uint8 NHWC images → C-major f32 logits ``[B, C, H/4, W/4]`` on
        the device."""
        return self._forward(self._normalize(self._to_device(images_u8)))

    def _argmax_levels(self, logits: torch.Tensor, consistent: bool) -> Dict[str, np.ndarray]:
        """Full-resolution C-major scores → per-level int32 masks (first
        maximum wins) on the host; ``consistent`` derives coarse/super from
        the fine mask."""
        masks = {lvl: logits[:, a:b].argmax(dim=1).to(torch.int32)
                 for lvl, (a, b) in self.level_slices.items()}
        if consistent:
            masks = self._consistent(masks)
        return {k: v.cpu().numpy() for k, v in masks.items()}

    def _consistent(self, masks: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        fine = masks["fine"].long()
        return dict(masks, **{lvl: lut[fine].to(torch.int32) for lvl, lut in self._luts.items()})

    def predict_masks(self, images_u8: Union[np.ndarray, torch.Tensor],
                      out_hw: Optional[Tuple[int, int]] = None,
                      consistent: bool = False) -> Dict[str, torch.Tensor]:
        """Masks-only prediction; the masks stay on the device.
        ``consistent=True`` derives coarse/super from the fine argmax
        through the hierarchy LUTs (tree-consistent labels). Its phases are
        the spans ``predict.upload``, ``predict.forward`` and
        ``predict.decode``."""
        out_hw = tuple(out_hw or tuple(images_u8.shape[1:3]))
        with torch.inference_mode():
            with trace.span("predict.upload"):
                x = self._to_device(images_u8)
            with trace.span("predict.forward"):
                logits = self._forward(self._normalize(x))
            with trace.span("predict.decode"):
                masks = decode_masks(logits, out_hw, self.level_slices,
                                     self.cfg.model.argmax_backend)
                if consistent:
                    masks = self._consistent(masks)
        return masks

    def predict_array(self, images_u8: np.ndarray,
                      out_hw: Optional[Tuple[int, int]] = None,
                      consistent: bool = False) -> Dict[str, np.ndarray]:
        """images_u8 [B, H, W, 3] → per-level int32 masks [B, out_h, out_w]
        (out defaults to the input size). ``consistent=False`` decodes each
        level by its own argmax, as the reference does. The span ``predict``
        holds ``predict.upload``, ``.forward``, ``.decode`` and ``.download``
        (the host blocked until the masks are on the host)."""
        with trace.span("predict"):
            masks = self.predict_masks(images_u8, out_hw, consistent)
            with trace.span("predict.download"):
                return {k: v.cpu().numpy() for k, v in masks.items()}

    def predict_sliding(self, images_u8: np.ndarray, window: Tuple[int, int],
                        stride: Optional[Tuple[int, int]] = None,
                        consistent: bool = False) -> Dict[str, np.ndarray]:
        """Sliding-window prediction of images larger than the model's
        resolution: overlapping windows (``stride`` defaults to half the
        window; the last window is flush with the edge) are forwarded one
        at a time, each window's logits are upsampled to the window and
        summed in f32 into a ``[B, C, H, W]`` accumulator on the device,
        divided by the per-pixel window count, then argmaxed per level."""
        B, H, W = images_u8.shape[:3]
        wh, ww = window
        sh, sw = stride or (wh // 2, ww // 2)
        if wh > H or ww > W:
            raise ValueError(f"window {window} larger than image {(H, W)}")
        C = self.cfg.hierarchy.total_classes
        with torch.inference_mode():
            x = self._to_device(images_u8)
            total = torch.zeros((B, C, H, W), dtype=torch.float32, device=self.device)
            counts = torch.zeros((H, W), dtype=torch.float32, device=self.device)
            for y0 in window_starts(H, wh, sh):
                for x0 in window_starts(W, ww, sw):
                    tile = self._normalize(x[:, y0:y0 + wh, x0:x0 + ww])
                    total[:, :, y0:y0 + wh, x0:x0 + ww] += resize_bilinear(
                        self._forward(tile), (wh, ww))
                    counts[y0:y0 + wh, x0:x0 + ww] += 1.0
            return self._argmax_levels(total / counts, consistent)

    def predict_tta(self, images_u8: np.ndarray, scales: Sequence[float] = (0.75, 1.0, 1.25),
                    flip: bool = True, out_hw: Optional[Tuple[int, int]] = None,
                    consistent: bool = False) -> Dict[str, np.ndarray]:
        """Multi-scale + horizontal-flip test-time augmentation: the
        normalized f32 images are resized per scale to
        ``max(round(H·s), 32)`` (Python's ``round``: halves to even), each
        view and, with ``flip``, its mirror is forwarded, the logits are
        resized to ``out_hw`` (the mirror's flipped back), and the
        per-level softmax probabilities are summed in f32 and argmaxed."""
        B, H, W = images_u8.shape[:3]
        out_hw = tuple(out_hw or (H, W))
        C = self.cfg.hierarchy.total_classes
        with torch.inference_mode():
            base = self._normalize(self._to_device(images_u8))
            acc = torch.zeros((B, C, *out_hw), dtype=torch.float32, device=self.device)
            for s in scales:
                hs, ws = max(int(round(H * s)), 32), max(int(round(W * s)), 32)
                view = base if (hs, ws) == (H, W) else resize_bilinear(base, (hs, ws))
                for mirrored in (False, True) if flip else (False,):
                    logits = resize_bilinear(self._forward(view.flip(3) if mirrored else view),
                                             out_hw)
                    if mirrored:
                        logits = logits.flip(3)
                    for a, b in self.level_slices.values():
                        acc[:, a:b] += torch.softmax(logits[:, a:b], dim=1)
            return self._argmax_levels(acc, consistent)

    def predict_image(self, path: str, consistent: bool = False
                      ) -> Tuple[Dict[str, np.ndarray], Image.Image]:
        """One image file: resized to ``transform.resize``, predicted, the
        masks at the image's original size."""
        arr, orig_hw, pil = preprocess_image(path, self.cfg.transform.resize)
        preds = self.predict_array(arr[None], out_hw=orig_hw, consistent=consistent)
        return {k: v[0] for k, v in preds.items()}, pil

    # ------------------------------------------------------------------
    def export_masks(self, preds: Mapping[str, np.ndarray], output_dir: str,
                     base_name: str) -> List[str]:
        """``{base_name}_{level}.png`` (grayscale) and
        ``{base_name}_{level}_color.png`` (palette + class indices) per
        level; returns the written paths."""
        h = self.cfg.hierarchy
        n_per_level = {"fine": h.n_fine, "coarse": h.n_coarse, "super": h.n_super}
        os.makedirs(output_dir, exist_ok=True)
        written = []
        for lvl, mask in preds.items():
            p = os.path.join(output_dir, f"{base_name}_{lvl}.png")
            save_mask(mask, p)
            color = mask_to_color_image(mask, create_colormap(n_per_level[lvl]))
            pc = os.path.join(output_dir, f"{base_name}_{lvl}_color.png")
            draw_class_indices(mask, color).save(pc)
            written += [p, pc]
        return written
