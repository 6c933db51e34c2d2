"""Epoch orchestration: the fit loop, evaluation and reporting (the port of
``seghiero_tpu/train/loop.py``). ``FitLoopMixin`` uses what ``Trainer``
builds: ``cfg``, ``model``, ``composite``, ``optimizer``, ``scheduler``,
``train_loader``, ``val_loader``, ``ckpt``, ``step``, ``start_epoch``,
``best_val_loss``.

Per-step losses stay on the device (one host sync per log interval and
one per epoch), as in the JAX loop. With ``output.profile_dir`` set, the
first epoch's steps 3–10 run under ``torch.profiler``, which writes
``trace.json`` and ``spans.json`` there (``trace.StepProfiler``).
"""

from __future__ import annotations

import json
import os
import time

import torch

from seghiero_torch import trace
from seghiero_torch.train.metrics import SegMetrics, ascii_table
from seghiero_torch.train.steps import eval_step, train_step

PROFILED_STEPS = (3, 10)  # output.profile_dir: the first epoch's steps, from 1


class StepTimer:
    """Running images/s over the steps after the first ``warmup_steps + 1``:
    the clock starts when step ``warmup_steps + 1`` has been issued, and
    only the images of later steps count (the JAX package's timer also
    counts that step's images, which its clock does not cover)."""

    def __init__(self, warmup_steps: int = 2):
        self.warmup_steps = warmup_steps
        self._steps, self._images, self._t0 = 0, 0, None

    def tick(self, batch_size: int) -> None:
        self._steps += 1
        if self._steps == self.warmup_steps + 1:
            self._t0, self._images = time.perf_counter(), 0
        elif self._t0 is not None:
            self._images += batch_size

    @property
    def images_per_sec(self):
        if self._t0 is None or self._images == 0:
            return None
        dt = time.perf_counter() - self._t0
        return self._images / dt if dt > 0 else None


class FitLoopMixin:
    def fit(self) -> list:
        cfg = self.cfg
        history = []
        path = cfg.output.metrics_jsonl
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            open(path, "w").close()  # one file per run
        n_train = len(self.train_loader)
        for epoch in range(self.start_epoch, cfg.training.epochs):
            timer = StepTimer()
            self.train_loader.set_epoch(epoch)
            loss_sum = torch.zeros((), device=self.device)
            loss_n, running = 0, 0.0
            t0 = time.perf_counter()
            prof = trace.StepProfiler(
                cfg.output.profile_dir if epoch == self.start_epoch else None,
                *PROFILED_STEPS)
            for batch in self.train_loader:
                prof.step()
                m = train_step(self.model, self.composite, self.optimizer, cfg, batch,
                               self.step, epoch, self.scheduler)
                self.step += 1
                loss_n += 1
                loss_sum += m["loss"]
                timer.tick(cfg.training.batch_size)
                if loss_n % cfg.training.log_every == 0 or loss_n == n_train:
                    running = float(m["loss"])  # one sync per log interval
                    if self.verbose:
                        ips = timer.images_per_sec
                        print(f"epoch {epoch + 1} step {loss_n}/{n_train} loss {running:.4f}"
                              + (f" ({ips:.1f} img/s)" if ips else ""), flush=True)
            prof.close()
            train_loss = float(loss_sum) / loss_n if loss_n else running  # waits for the card
            train_time = time.perf_counter() - t0
            # read before the evaluation, whose time the JAX loop's rate includes
            train_ips = timer.images_per_sec

            val = self.evaluate()
            record = {
                "epoch": epoch + 1,
                "train_loss": train_loss,
                "val_loss": val["loss"],
                "val_acc": val["fine_acc"],
                "val_fine_miou": val["fine_miou"],
                "val_coarse_miou": val.get("coarse_miou"),
                "train_images_per_sec": train_ips,
                "train_seconds": train_time,
            }
            if cfg.hierarchy.has_super:  # the port's record and table add the super level
                record["val_super_miou"] = val["super_miou"]
            history.append(record)
            if path:
                with open(path, "a") as f:
                    f.write(json.dumps(record) + "\n")
            if self.verbose:
                head = ["Epoch", "Avg Train Loss", "Avg Val Loss", "Val Pixel Acc", "Val fine mIoU"]
                row = [epoch + 1, f"{train_loss:.4f}", f"{val['loss']:.4f}",
                       f"{val['fine_acc'] * 100:.2f}%", f"{val['fine_miou'] * 100:.2f}%"]
                if cfg.hierarchy.has_super:
                    head.append("Val super mIoU")
                    row.append(f"{val['super_miou'] * 100:.2f}%")
                print(ascii_table([head, row]), flush=True)
            is_best = val["loss"] < self.best_val_loss
            if is_best:
                self.best_val_loss = val["loss"]
                self._epochs_since_best = 0
            else:
                self._epochs_since_best += 1
            self.ckpt.save(self.model, self.optimizer, self.scheduler, step=self.step,
                           epoch=epoch + 1, metrics=record, best_val_loss=self.best_val_loss,
                           config_raw=cfg.raw, is_best=is_best)
            if is_best and self.verbose:
                print(f"→ Saved new best model (val_loss {val['loss']:.4f})\n")
            patience = cfg.training.early_stop_patience
            if patience and self._epochs_since_best >= patience:
                if self.verbose:
                    print(f"→ Early stop: no val-loss improvement for {patience} epoch(s) "
                          f"(best {self.best_val_loss:.4f})")
                break
        if self.verbose and self._last_eval is not None:
            print(self._iou_table(self._last_eval))
        return history

    def _iou_table(self, acc: SegMetrics) -> str:
        names = {"fine": self.cfg.fine_names, "coarse": self.cfg.coarse_names}
        if self.cfg.hierarchy.has_super:
            names["super"] = self.cfg.super_names
        return acc.iou_table(names)

    def evaluate(self, with_table: bool = False):
        """Loss, pixel accuracy, mIoU and mAcc per level (fine, coarse and,
        for a 3-level hierarchy, super) over the val split (device results
        gathered once at the end); with ``with_table``, also the per-class
        IoU table, as ``(summary, table)``."""
        h = self.cfg.hierarchy
        levels = {"fine": h.n_fine, "coarse": h.n_coarse}
        if h.has_super:
            levels["super"] = h.n_super
        acc = SegMetrics(levels)
        outs = [eval_step(self.model, self.composite, self.cfg, batch, self.step)
                for batch in self.val_loader]
        for out in outs:
            acc.update(float(out["loss"]), {
                lvl: {k: v.cpu().numpy() for k, v in s.items()}
                for lvl, s in out["levels"].items()})
        self._last_eval = acc
        if with_table:
            return acc.summary(), self._iou_table(acc)
        return acc.summary()
