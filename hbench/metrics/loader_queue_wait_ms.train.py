"""The train loop's wait on the loader's queue a batch (ms): the
program's ``loader.wait`` span (``seghiero_torch/trace.py``) over the
traced segment, over its count; nothing to read in a program without
spans."""


def read(run):
    if run.kind != "train" or not run.trace:
        return None
    try:
        from seghiero_torch.trace import totals
    except ImportError:
        return None
    s = totals().get("loader.wait")
    if not s or not s["count"]:
        return None
    return 1e3 * s["seconds"] / s["count"]
