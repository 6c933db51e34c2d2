"""Training orchestration (the port of ``seghiero_tpu/train/trainer.py``):
construction of the model, data, optimizer, schedule, loss and
checkpoints; the epoch loop lives in ``train/loop.py``.

One device and no mesh (multi-GPU waits, ROADMAP queue 1 item 7). The
model keeps f32 parameters and runs its forward under bf16 autocast for
``model.dtype: bfloat16``; on the card it is channels_last, the layout
cuDNN and the depthwise kernels take. The entry point runs on ``cuda``
unless the caller passes ``device="cpu"``, and raises without a card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from seghiero_torch.config import SegHieroConfig, not_yet_ported
from seghiero_torch.data.dataset import build_dataset
from seghiero_torch.data.pipeline import BatchLoader
from seghiero_torch.infer.predictor import resolve_device
from seghiero_torch.models.convert import load_pretrained_backbone
from seghiero_torch.models.segmenter import build_model, seeded_init_
from seghiero_torch.train.checkpoint import CheckpointManager
from seghiero_torch.train.loop import FitLoopMixin
from seghiero_torch.train.optim import make_optimizer, make_schedule
from seghiero_torch.train.steps import check_step_options, make_composite_loss


def _check_model_options(cfg: SegHieroConfig) -> None:
    if cfg.model.pretrained is True:
        raise ValueError(
            "model.pretrained: true needs a local weight file (there is no "
            "download); set model.pretrained to a torchvision ResNet .pth path, "
            "or to false for a fresh init"
        )
    if isinstance(cfg.model.pretrained, str) and cfg.model.backbone != "resnet":
        raise NotImplementedError(
            f"model.pretrained for model.backbone: {cfg.model.backbone} is not yet ported to "
            "seghiero_torch (ROADMAP.md); the port loads torchvision ResNet files only, and "
            "the import of MiT's, Swin's and ViT's official releases waits")
    if cfg.model.remat:
        raise not_yet_ported("model.remat")


@dataclasses.dataclass
class Trainer(FitLoopMixin):
    """``Trainer(cfg, device=None, resume=False).fit()``."""

    cfg: SegHieroConfig
    device: Any = None
    verbose: bool = True
    resume: bool = False

    def __post_init__(self):
        cfg = self.cfg
        self.device = resolve_device(self.device)
        _check_model_options(cfg)
        check_step_options(cfg)
        self.composite = make_composite_loss(cfg)
        torch.manual_seed(cfg.training.seed)
        model = seeded_init_(build_model(cfg), cfg.training.seed)
        if isinstance(cfg.model.pretrained, str):
            load_pretrained_backbone(model, cfg.model.pretrained, cfg.model.depth)
            if self.verbose:
                print(f"→ Loaded pretrained backbone from {cfg.model.pretrained}")
        if self.device.type == "cuda":
            model = model.to(self.device, memory_format=torch.channels_last)
        self.model = model.to(self.device)
        # the train step derives its targets on the card: the train set
        # skips the level masks, eval keeps them for its metrics
        self.train_ds = build_dataset(cfg, "train", seed=cfg.training.seed,
                                      include_levels=False, verbose=self.verbose)
        self.val_ds = build_dataset(cfg, "val", seed=cfg.training.seed, verbose=self.verbose)
        t = cfg.training
        self.train_loader = BatchLoader(self.train_ds, t.batch_size, shuffle=True,
                                        drop_last=True, seed=t.seed, device=self.device,
                                        num_workers=t.num_workers)
        self.val_loader = BatchLoader(self.val_ds, t.batch_size, shuffle=False,
                                      drop_last=False, device=self.device,
                                      num_workers=t.num_workers)
        total_steps = len(self.train_loader) * t.epochs
        self.optimizer = make_optimizer(t, self.model)
        self.scheduler = make_schedule(t, total_steps, self.optimizer)
        self.step = 0
        self.start_epoch = 0
        self.best_val_loss = float("inf")
        self._epochs_since_best = 0
        self._last_eval: Optional[Any] = None
        self.ckpt = CheckpointManager(cfg.output.checkpoint_dir, cfg.output.project_name)
        if self.resume:
            meta = self.ckpt.restore_latest(self.model, self.optimizer, self.scheduler)
            if meta is not None:
                self.step = int(meta["step"])
                self.start_epoch = int(meta.get("epoch", 0))
                self.best_val_loss = float(meta.get("best_val_loss", float("inf")))
                if self.verbose:
                    print(f"→ Resumed from epoch {self.start_epoch} (step {self.step})")
