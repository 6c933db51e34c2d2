"""Share of the traced inference calls with nothing on the card (%)."""


def read(run):
    if run.kind != "infer" or not run.trace or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
