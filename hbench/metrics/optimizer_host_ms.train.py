"""Host time of the train step's optimizer a step (ms): ``zero_grad``,
the zero fill of missing gradients, the clip, ``SGD.step``, the schedule.
The program's ``train.optimizer`` spans (``seghiero_torch/trace.py``)
over the traced segment, over its ``train.step`` count; nothing to read
in a program without spans."""


def read(run):
    if run.kind != "train" or not run.trace:
        return None
    try:
        from seghiero_torch.trace import totals
    except ImportError:
        return None
    t = totals()
    steps = t.get("train.step", {}).get("count")
    if "train.optimizer" not in t or not steps:
        return None
    return 1e3 * t["train.optimizer"]["seconds"] / steps
