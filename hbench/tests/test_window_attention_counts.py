"""``window_attention_roofline.train``'s predicted launches held to the
plain reference: at ``swinl-2level.train-640``'s full size (Swin-L, batch
2 of 640²), the ``(B·nW, h, N, d)`` of each block, and whether it is
shifted, as the metric reckons them from the unit's batch and input size,
equal what a meta-device pass of ``reference/swin.py`` gives to its
window attention, block by block.

    python -m pytest hbench/tests -q
"""

import torch

from hbench.core import geometry, spec
from hbench.reference.tree import from_classes

CELL = "swinl-2level.train-640"


def test_predicted_window_attention_shapes_match_a_reference_pass(monkeypatch):
    bench = spec.Bench()
    config = bench.config(bench.workload(CELL)["config"])
    mode = config["modes"]["train"]
    ref = bench.reference(config)
    tree = from_classes(config["classes"])
    batch, hw = int(mode["training"]["batch_size"]), tuple(mode["transform"]["resize"])
    u = geometry.unit(batch, hw, tree, ref, mode["model"], train=True)
    seen = []
    real = ref.window_attention

    def record(q, k, v, bias):
        seen.append((*q.shape, bias.shape[0] > 1))
        return real(q, k, v, bias)

    monkeypatch.setattr(ref, "window_attention", record)
    model = ref.build(mode["model"], tree)
    with torch.no_grad():
        model(torch.zeros(batch, 3, *hw, device="meta"), with_train_heads=True)
    metric = bench.metric_reader("window_attention_roofline.train")
    assert [tuple(b) for b in metric.blocks(u)] == seen
    assert len(seen) == 24 and sum(s[-1] for s in seen) == 12
    # every stage pads: 160, 80, 40, 20 to 168, 84, 48, 24
    assert sorted({s[0] for s in seen}) == [2 * 4, 2 * 16, 2 * 49, 2 * 196]
