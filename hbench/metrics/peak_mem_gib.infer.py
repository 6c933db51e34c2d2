"""The card's peak allocated memory over the inference window (GiB)."""


def read(run):
    if run.kind != "infer" or not run.window_peak_bytes:
        return None
    return run.window_peak_bytes / 2**30
