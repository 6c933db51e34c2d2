"""Share of the traced training steps that the program issued as one CUDA
graph's replay (%): the count of its ``train.replay`` span over the count
of ``train.step`` (``seghiero_torch/trace.py``), over the traced segment.
Nothing to read in a program without the span, or where no step replayed."""


def read(run):
    if run.kind != "train" or not run.trace:
        return None
    try:
        from seghiero_torch.trace import totals
    except ImportError:
        return None
    t = totals()
    steps = t.get("train.step", {}).get("count")
    replays = t.get("train.replay", {}).get("count")
    if not steps or replays is None:
        return None
    return 100.0 * replays / steps
