"""Share of the traced training steps with no kernel, copy or set on the
card (%): one minus the union of the device's intervals over the traced
window."""


def read(run):
    if run.kind != "train" or not run.trace or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
