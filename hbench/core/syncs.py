"""Host synchronizations in one call, from PyTorch's sync debug mode:
how many, and the source lines that asked for them."""

from __future__ import annotations

import collections
import warnings
from pathlib import Path
from typing import Callable, Dict, Tuple


def audit(fn: Callable[[], None]) -> Tuple[int, Dict[str, int]]:
    """Count the syncs of one call of ``fn`` (the caller warms it up)."""
    import torch

    if not torch.cuda.is_available():
        fn()
        return 0, {}
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    where = collections.Counter(f"{'/'.join(Path(w.filename).parts[-2:])}:{w.lineno}"
                                for w in syncs)
    return len(syncs), dict(where.most_common(12))
