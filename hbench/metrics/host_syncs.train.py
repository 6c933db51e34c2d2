"""Host synchronizations in one steady ``train_step`` (a count), from
PyTorch's sync debug mode (``hbench/core/syncs.py``)."""


def read(run):
    if run.kind != "train":
        return None
    return run.extras.get("host_syncs")
