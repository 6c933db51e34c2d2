"""Loader wait a step (ms): the window's total time in the harness span
around each ``next()`` on the program's ``BatchLoader``, over its steps."""


def read(run):
    waits = run.spans.get("loader_wait")
    if run.kind != "train" or not waits or not run.units:
        return None
    return 1e3 * sum(waits) / run.units
