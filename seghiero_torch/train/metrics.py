"""Segmentation metrics (the port of ``seghiero_tpu/train/metrics.py``):
per-level confusion matrix and pixel-accuracy counts on the device,
mIoU / mAcc / per-class IoU from the accumulated matrix on the host."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


def confusion_matrix(preds: torch.Tensor, labels: torch.Tensor, num_classes: int,
                     ignore_index: int = 255) -> torch.Tensor:
    """``[num_classes, num_classes]`` int64 counts over non-ignored pixels
    (rows = truth, columns = prediction)."""
    valid = labels != ignore_index
    t = labels[valid].long()
    p = preds[valid].long()
    return torch.bincount(t * num_classes + p, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes)


def pixel_accuracy_counts(preds, labels, ignore_index: int = 255):
    """(correct, valid) pixel counts."""
    valid = labels != ignore_index
    return ((preds == labels) & valid).sum(), valid.sum()


def per_class_iou(cm: np.ndarray) -> np.ndarray:
    """IoU per class (NaN for classes absent from truth and prediction)."""
    cm = np.asarray(cm, np.float64)
    tp = np.diag(cm)
    denom = cm.sum(0) + cm.sum(1) - tp
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(denom > 0, tp / denom, np.nan)


def miou_from_confusion(cm: np.ndarray) -> float:
    """Mean IoU over classes that appear in truth or prediction."""
    ious = per_class_iou(cm)
    present = ~np.isnan(ious)
    return float(np.mean(ious[present])) if present.any() else 0.0


def macc_from_confusion(cm: np.ndarray) -> float:
    """Mean per-class recall over classes present in truth (mmseg's mAcc)."""
    cm = np.asarray(cm, np.float64)
    tp, truth = np.diag(cm), cm.sum(1)
    present = truth > 0
    return float(np.mean(tp[present] / truth[present])) if present.any() else 0.0


def ascii_table(rows) -> str:
    cells = [[str(c) for c in row] for row in rows]
    widths = [max(len(r[i]) for r in cells) for i in range(len(cells[0]))]
    line = "+" + "+".join("-" * (w + 2) for w in widths) + "+"

    def fmt(row):
        return "| " + " | ".join(c.ljust(w) for c, w in zip(row, widths)) + " |"

    return "\n".join([line, fmt(cells[0]), line, *map(fmt, cells[1:]), line])


@dataclasses.dataclass
class SegMetrics:
    """Host-side accumulator over eval batches."""

    num_classes_per_level: Dict[str, int]
    cms: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    correct: Dict[str, int] = dataclasses.field(default_factory=dict)
    valid: Dict[str, int] = dataclasses.field(default_factory=dict)
    loss_sum: float = 0.0
    batches: int = 0

    def __post_init__(self):
        for lvl, n in self.num_classes_per_level.items():
            self.cms[lvl] = np.zeros((n, n), np.int64)
            self.correct[lvl] = 0
            self.valid[lvl] = 0

    def update(self, loss: float, level_stats: Dict[str, Dict]):
        self.loss_sum += float(loss)
        self.batches += 1
        for lvl, s in level_stats.items():
            self.cms[lvl] += np.asarray(s["cm"], np.int64)
            self.correct[lvl] += int(s["correct"])
            self.valid[lvl] += int(s["valid"])

    def summary(self) -> Dict[str, float]:
        out = {"loss": self.loss_sum / max(self.batches, 1)}
        for lvl in self.num_classes_per_level:
            out[f"{lvl}_acc"] = self.correct[lvl] / max(self.valid[lvl], 1)
            out[f"{lvl}_miou"] = miou_from_confusion(self.cms[lvl])
            out[f"{lvl}_macc"] = macc_from_confusion(self.cms[lvl])
        return out

    def iou_table(self, names_per_level: Dict[str, Dict[int, str]]) -> str:
        rows = [["Level", "Class", "Name", "IoU"]]
        for lvl, cm in self.cms.items():
            names = names_per_level.get(lvl, {})
            for cid, iou in enumerate(per_class_iou(cm)):
                rows.append([lvl, cid, names.get(cid, ""),
                             "-" if np.isnan(iou) else f"{iou * 100:.2f}%"])
        return ascii_table(rows)
