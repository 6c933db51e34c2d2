"""The fault planted for ``vitl16-3level.train-1024``, rehearsed on the CPU.

At the cell's batch of one image, half the batch does not exist; half the
pixels does: a step whose loss leaves out the bottom half of every label
map (as ignored, 255) reads gaps the limits refuse
(``limits/vitl16-3level.train-1024.json``, ``half_pixels``).

    python -m pytest hbench/tests -q
"""

from hbench.tests.test_rehearsal import rehearse

CELL = "vitl16-3level.train-1024"


def test_half_the_pixels_left_out_of_the_loss_is_not_correct(monkeypatch):
    from seghiero_torch.train import steps

    real = steps.train_step

    def half_pixels(model, composite, optimizer, cfg, batch, step, epoch=0, scheduler=None):
        fine = batch["fine"].clone()
        fine[:, fine.shape[1] // 2:] = 255
        return real(model, composite, optimizer, cfg, dict(batch, fine=fine), step, epoch,
                    scheduler)

    monkeypatch.setattr(steps, "train_step", half_pixels)
    out = rehearse(CELL)
    assert out["correct"] is False
    assert out["checks"]["logits_gap"]["value"] <= out["checks"]["logits_gap"]["limit"]


def test_the_reading_script_gives_the_fault_above_its_limit():
    """``hbench/half_pixels.py``, which read the fault's upper reading at full
    size on the card, reads it at the rehearsal's size on the CPU: the
    reference's steps with half the pixels ignored are refused by the
    limit on ``loss_gap_median`` they set."""
    from hbench import half_pixels
    from hbench.tests.test_rehearsal import BENCH, SEED

    numbers, peak = half_pixels.read(BENCH, CELL, SEED, "cpu", BENCH.rehearsal(CELL))
    assert peak == 0 and set(numbers) == set(half_pixels.KEYS)
    assert numbers["loss_gap_median"] > BENCH.limits(CELL)["loss_gap_median"]["limit"]
