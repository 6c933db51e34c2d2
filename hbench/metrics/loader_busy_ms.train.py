"""The loader's time to make a batch (ms): fetch, transforms, collate,
pad and pin, in its worker thread. The program's ``loader.batch`` span
(``seghiero_torch/trace.py``) over the traced segment, over its count;
nothing to read in a program without spans."""


def read(run):
    if run.kind != "train" or not run.trace:
        return None
    try:
        from seghiero_torch.trace import totals
    except ImportError:
        return None
    s = totals().get("loader.batch")
    if not s or not s["count"]:
        return None
    return 1e3 * s["seconds"] / s["count"]
