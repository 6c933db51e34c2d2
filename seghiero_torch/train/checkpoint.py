"""Checkpoints with resume (the port of ``seghiero_tpu/train/checkpoint.py``).

Each save is a directory ``<checkpoint_dir>/<project>/step_NNNNNNNN/``:

* ``model.pth`` — the model in the reference ``.pth`` layout
  (``backbone_state_dict`` / ``aspp_head_state_dict`` /
  ``aux_head_state_dict`` + ``epoch``; ``models/convert.py``), which the
  predictor and the original SegHiero load as they are;
* ``train_state.pt`` — the optimizer's and the schedule's state and the
  optimizer step;
* ``meta.json`` — epoch, best_val_loss, metrics and the raw config.

A save is written under a temporary name and renamed when complete, so a
listed step directory is always whole. ``best.json`` points at the best
step (``best_step``); ``restore_latest`` resumes, and the oldest saves
beyond ``max_to_keep`` (never the best) are removed.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional

import torch

from seghiero_torch.models.convert import load_reference_checkpoint, reference_checkpoint
from seghiero_torch.train.optim import load_optimizer_state
from seghiero_torch.train.steps import forget_step_graph

MODEL_FILE = "model.pth"


def step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


def list_steps(root: str) -> List[int]:
    """The saved steps under the project directory ``root``, ascending."""
    if not os.path.isdir(root):
        return []
    return sorted(int(d[5:]) for d in os.listdir(root)
                  if d.startswith("step_") and d[5:].isdigit()
                  and os.path.isdir(os.path.join(root, d)))


def read_best_step(root: str) -> Optional[int]:
    """The step ``best.json`` under ``root`` points at, or None."""
    p = os.path.join(root, "best.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(json.load(f)["step"])


def best_model_file(root: str) -> Optional[str]:
    """The model file of the best step under the project directory
    ``root``, else of its latest step (the best step's directory may have
    been removed by hand); None when ``root`` holds no saved step."""
    files = [os.path.join(step_dir(root, s), MODEL_FILE)
             for s in (read_best_step(root), *reversed(list_steps(root))) if s is not None]
    return next((f for f in files if os.path.isfile(f)), None)


class CheckpointManager:
    def __init__(self, directory: str, project_name: str, max_to_keep: int = 3):
        self.root = os.path.abspath(os.path.join(directory, project_name))
        os.makedirs(self.root, exist_ok=True)
        self.max_to_keep = max_to_keep

    def step_dir(self, step: int) -> str:
        return step_dir(self.root, step)

    def steps(self) -> List[int]:
        return list_steps(self.root)

    def save(self, model, optimizer, scheduler, *, step: int, epoch: int, metrics: Dict,
             best_val_loss: float, config_raw: Dict, is_best: bool) -> str:
        final = self.step_dir(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        ckpt = reference_checkpoint(model)
        ckpt["epoch"] = epoch
        torch.save(ckpt, os.path.join(tmp, MODEL_FILE))
        torch.save({
            "step": step,
            "optimizer": optimizer.state_dict(),
            "scheduler": scheduler.state_dict() if scheduler is not None else None,
        }, os.path.join(tmp, "train_state.pt"))
        meta = {"step": step, "epoch": epoch,
                "metrics": {k: v for k, v in metrics.items() if v is not None},
                "best_val_loss": best_val_loss, "config": config_raw}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1, default=float)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        if is_best:
            with open(os.path.join(self.root, "best.json"), "w") as f:
                json.dump({"step": step}, f)
        self._gc()
        return final

    def best_step(self) -> Optional[int]:
        return read_best_step(self.root)

    def _gc(self) -> None:
        best = self.best_step()
        removable = [s for s in self.steps() if s != best]
        for s in removable[: max(0, len(removable) - self.max_to_keep)]:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)

    def restore(self, step: int, model, optimizer=None, scheduler=None) -> Dict:
        """Load step ``step`` into ``model`` (and the optimizer / schedule
        when given); returns its ``meta.json`` with the optimizer step."""
        d = self.step_dir(step)
        ckpt = torch.load(os.path.join(d, MODEL_FILE), map_location="cpu", weights_only=True)
        load_reference_checkpoint(model, ckpt)
        state = torch.load(os.path.join(d, "train_state.pt"), map_location="cpu",
                           weights_only=True)
        if optimizer is not None:
            forget_step_graph(optimizer)  # its graph holds the state replaced here
            load_optimizer_state(optimizer, state["optimizer"])
        if scheduler is not None and state["scheduler"] is not None:
            scheduler.load_state_dict(state["scheduler"])
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        meta["step"] = int(state["step"])
        return meta

    def restore_latest(self, model, optimizer=None, scheduler=None) -> Optional[Dict]:
        steps = self.steps()
        return self.restore(steps[-1], model, optimizer, scheduler) if steps else None
