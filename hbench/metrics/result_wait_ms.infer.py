"""The host's wait for a prediction call's masks (ms): the program's
``predict.download`` span (``seghiero_torch/trace.py``) over the traced
segment, over its ``predict`` calls. Nothing to read in a program without
spans."""


def read(run):
    if run.kind != "infer" or not run.trace:
        return None
    try:
        from seghiero_torch.trace import totals
    except ImportError:
        return None
    t = totals()
    calls = t.get("predict", {}).get("count")
    if "predict.download" not in t or not calls:
        return None
    return 1e3 * t["predict.download"]["seconds"] / calls
