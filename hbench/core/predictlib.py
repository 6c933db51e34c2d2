"""What the prediction cells share: the program's ``Predictor`` holding
the harness's weights (BatchNorm statistics calibrated once from the
seed), and the reference's check of returned masks: at every pixel, how
far the reference's logit of the returned class lies below its best. The
reference is the configuration's own model module (``ctx.reference``)."""

from __future__ import annotations

import contextlib
import gc
from types import ModuleType
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hbench.core import weights
from hbench.core.trainlib import full_fp32
from hbench.reference import compare, lowp
from hbench.reference.train import normalize


def seeded_weights(reference: ModuleType, port: Dict, tree, seed: int, device, stats=None):
    """The state dict for a prediction cell of the model of ``reference``:
    seeded, then calibrated (or given the BatchNorm statistics ``stats`` of
    an earlier calibration)."""
    sd = weights.make(reference.build(port["model"], tree), seed, device,
                      reference.RESIDUAL_LAST)
    if stats is not None:
        return dict(sd, **stats)
    with full_fp32():
        model = weights.materialize(reference.build(port["model"], tree), sd, device)
        sd = weights.calibrate_(model, sd, seed, tree.n_fine, port.get("transform", {}))
    del model
    return sd


def predictor(port: Dict, sd, device):
    """The program's predictor for ``port`` holding ``sd``."""
    from seghiero_torch.config import SegHieroConfig
    from seghiero_torch.infer.predictor import Predictor

    p = Predictor(SegHieroConfig.from_dict(port), None, device)
    p.model.load_state_dict(sd, strict=True)
    return p


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class Reference:
    """The float32 reference model (TF32 off) of a prediction cell."""

    def __init__(self, reference: ModuleType, port: Dict, tree, sd, device):
        self.port, self.tree, self.device = port, tree, device
        self.model = weights.materialize(reference.build(port["model"], tree), sd,
                                         device).eval()

    @torch.no_grad()
    def logits(self, image_u8: np.ndarray, fp8: bool = False) -> torch.Tensor:
        """One uint8 ``[H, W, 3]`` image at the model's input size → the
        logits upsampled to that size, ``[C, H, W]`` f32."""
        x = torch.from_numpy(np.ascontiguousarray(image_u8))[None].to(self.device)
        with full_fp32(), (lowp.fp8() if fp8 else contextlib.nullcontext()):
            lo = self.model(normalize(x, self.port.get("transform", {})),
                            with_train_heads=False)["logits"]
        return F.interpolate(lo, size=image_u8.shape[:2], mode="bilinear",
                             align_corners=False)[0]

    def gaps(self, ref: torch.Tensor, masks: Dict[str, np.ndarray]) -> List[float]:
        """The widest gap of each level's mask; a level missing reads
        infinite."""
        out = []
        for lvl, (a, b) in self.tree.levels.items():
            if lvl not in masks:
                out.append(float("inf"))
                continue
            out.append(compare.widest_gap(ref[a:b], torch.from_numpy(np.asarray(masks[lvl]))))
        return out

    def control_masks(self, image_u8: np.ndarray) -> Tuple[torch.Tensor, Dict[str, np.ndarray]]:
        """(f32 logits, the masks the fp8 control puts first)."""
        ref = self.logits(image_u8)
        low = self.logits(image_u8, fp8=True)
        masks = {lvl: low[a:b].argmax(0).cpu().numpy()
                 for lvl, (a, b) in self.tree.levels.items()}
        return ref, masks
