"""``python -m seghiero_torch.train --config <yaml> [--device cpu] [--resume] [--eval-only]``:
train a hierarchical segmentation model from a single YAML config on the
card (the port of the JAX package's ``train.py``). ``--eval-only``
restores the latest checkpoint (or keeps the fresh init when there is
none) and prints the val metrics and the per-class IoU table instead."""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0].strip("`"))
    p.add_argument("--config", required=True, help="path to the YAML config")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; the CPU only when asked for)")
    p.add_argument("--resume", action="store_true", help="resume from the latest checkpoint")
    p.add_argument("--eval-only", action="store_true",
                   help="no training: restore the latest checkpoint (or evaluate the "
                   "fresh init if none exists) and print val metrics + the per-class "
                   "IoU table")
    p.add_argument("--quiet", action="store_true", help="less console output")
    args = p.parse_args(argv)

    from seghiero_torch.config import load_config
    from seghiero_torch.train.metrics import ascii_table
    from seghiero_torch.train.trainer import Trainer

    cfg = load_config(args.config)
    trainer = Trainer(cfg, device=args.device, verbose=not args.quiet,
                      resume=args.resume or args.eval_only)
    h = cfg.hierarchy
    print(f"Number of train samples: {len(trainer.train_ds)}")
    print(f"Number of val   samples: {len(trainer.val_ds)}")
    print(f"n_fine={h.n_fine}, n_coarse={h.n_coarse}, has_super={h.has_super}, "
          f"n_super={h.n_super}; total classes {h.total_classes}; device {trainer.device}")
    if args.eval_only:
        if trainer.start_epoch == 0:
            print("→ No checkpoint found; evaluating the fresh init.")
        summary, iou_table = trainer.evaluate(with_table=True)
        print(ascii_table([
            ["Val Loss", "Val Pixel Acc", "Val fine mIoU"],
            [f"{summary['loss']:.4f}", f"{summary['fine_acc'] * 100:.2f}%",
             f"{summary['fine_miou'] * 100:.2f}%"],
        ]))
        print(iou_table)
        print("Evaluation complete.")
        return 0
    trainer.fit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
