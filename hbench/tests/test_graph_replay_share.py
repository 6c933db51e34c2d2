"""``metrics/graph_replay_share.train.py`` on planted span totals: the
count of ``train.replay`` over the count of ``train.step``, in percent;
nothing where the program has no such span, no step was traced, or the run
is not a traced training run.

    python -m pytest hbench/tests -q
"""

import types

import pytest

from hbench.core import spec

READER = spec.Bench().metric_reader("graph_replay_share.train")
SEG = {"busy_s": 0.5, "window_s": 1.0}


def _read(monkeypatch, totals, kind="train", trace=SEG):
    from seghiero_torch import trace as program_trace

    monkeypatch.setattr(program_trace, "totals", lambda: totals)
    return READER.read(types.SimpleNamespace(kind=kind, trace=trace))


def _span(count):
    return {"count": count, "seconds": 0.01 * count, "parent": None}


@pytest.mark.parametrize("steps,replays,want", [(4, 4, 100.0), (4, 3, 75.0), (8, 0, 0.0)])
def test_the_share_of_steps_replayed(monkeypatch, steps, replays, want):
    totals = {"train.step": _span(steps), "train.replay": _span(replays),
              "train.forward": _span(steps - replays)}
    assert _read(monkeypatch, totals) == pytest.approx(want)


@pytest.mark.parametrize("totals", [
    {"train.step": _span(4), "train.forward": _span(4)},  # a program without the span
    {"train.replay": _span(4)},  # no step traced
    {},
])
def test_nothing_to_read(monkeypatch, totals):
    assert _read(monkeypatch, totals) is None


def test_only_a_traced_training_run(monkeypatch):
    totals = {"train.step": _span(4), "train.replay": _span(4)}
    assert _read(monkeypatch, totals, kind="infer") is None
    assert _read(monkeypatch, totals, trace=None) is None
