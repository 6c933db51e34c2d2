"""Host time of the model's backbone a training step (ms): the program's
``model.backbone`` span (``seghiero_torch/models/segmenter.py``, inside
``train.forward``) over the traced segment, over its ``train.step``
count; nothing to read in a program without that span."""


def read(run):
    if run.kind != "train" or not run.trace:
        return None
    try:
        from seghiero_torch.trace import totals
    except ImportError:
        return None
    t = totals()
    steps = t.get("train.step", {}).get("count")
    if "model.backbone" not in t or not steps:
        return None
    return 1e3 * t["model.backbone"]["seconds"] / steps
