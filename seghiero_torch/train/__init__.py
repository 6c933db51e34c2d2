"""Training: steps, loop, metrics, optimizer and checkpoints (the port of
``seghiero_tpu/train``). ``python -m seghiero_torch.train --config …``."""

from seghiero_torch.train.trainer import Trainer

__all__ = ["Trainer"]
