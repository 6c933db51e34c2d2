"""The card's peak allocated memory over the training window (GiB), from
``torch.cuda.max_memory_allocated`` after a reset at the window's start."""


def read(run):
    if run.kind != "train" or not run.window_peak_bytes:
        return None
    return run.window_peak_bytes / 2**30
