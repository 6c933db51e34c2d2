"""The program's hand-written kernels in the traced training steps (%):
the least time of their launches (``hbench/kernels/``) over their device
time from the profiler (``hbench/core/kernelwork.py``)."""

from hbench.core import kernelwork


def read(run):
    if run.kind != "train" or not run.trace:
        return None
    return kernelwork.roofline(run.trace, run.kernels)
