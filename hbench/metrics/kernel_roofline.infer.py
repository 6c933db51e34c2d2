"""The program's hand-written kernels in the traced inference calls (%):
the least time of their launches over their device time."""

from hbench.core import kernelwork


def read(run):
    if run.kind != "infer" or not run.trace:
        return None
    return kernelwork.roofline(run.trace, run.kernels)
