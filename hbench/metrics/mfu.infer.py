"""Inference's share of the card's bf16 peak (%): forward FLOPs an image
(counted on the plain reference) times the window's images/s, over 989
TFLOP/s."""

from hbench.core import peaks


def read(run):
    rate, fl = run.e2e.get("infer_images_per_s"), run.extras.get("flops_per_image")
    if run.kind != "infer" or not rate or not fl:
        return None
    return 100.0 * fl * rate / peaks.BF16_FLOPS
