"""Host time to issue a prediction call (ms): the program's
``predict.upload``, ``predict.forward`` and ``predict.decode`` spans
(``seghiero_torch/trace.py``) over the traced segment, over its
``predict`` calls. Nothing to read in a program without spans."""

PARTS = ("predict.upload", "predict.forward", "predict.decode")


def read(run):
    if run.kind != "infer" or not run.trace:
        return None
    try:
        from seghiero_torch.trace import totals
    except ImportError:
        return None
    t = totals()
    calls = t.get("predict", {}).get("count")
    if not calls or not all(p in t for p in PARTS):
        return None
    return 1e3 * sum(t[p]["seconds"] for p in PARTS) / calls
