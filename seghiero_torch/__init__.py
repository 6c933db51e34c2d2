"""seghiero_torch — the PyTorch/CUDA port of ``seghiero_tpu`` for NVIDIA
Hopper (H100).

Same YAML configs, same checkpoint layout, same serving contract as the
JAX package; the Pallas TPU kernels on the ported path are rewritten by
hand in CUDA C++ (``seghiero_torch/csrc``, built at first use by
``seghiero_torch/ops/_build.py``). This package imports ``torch`` and
never the JAX package.

Ported so far: the serving path (normalize → ResNet backbone →
sep-ASPP contrast head → 4× upsample + per-level argmax → HTTP
micro-batching server). Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

from seghiero_torch.config import SegHieroConfig, load_config
from seghiero_torch.hierarchy import Hierarchy, build_fine_to_level_map
from seghiero_torch.version import __version__

__all__ = [
    "__version__",
    "Hierarchy",
    "build_fine_to_level_map",
    "SegHieroConfig",
    "load_config",
]
