"""``global_attention_roofline.train``'s predicted launches held to the
plain reference and pinned: at ``vitl16-3level.train-1024``'s full size
(ViT-L/16, batch 1 of 1024²), the ``(B, h, N, d)`` of each block as the
metric reckons them from the unit's batch and input size and the ViT
constants of the cells it lists (this cell's configuration) equal what a
meta-device pass of ``reference/vit.py`` gives to its attention, block by
block; and each launch's work is the one written out here.

    python -m pytest hbench/tests -q
"""

import pytest
import torch

from hbench.core import geometry, peaks, spec
from hbench.reference.tree import from_classes

CELL = "vitl16-3level.train-1024"
N = 64 * 64 + 1  # the 64² patch grid and the CLS token


def test_predicted_global_attention_shapes_match_a_reference_pass(monkeypatch):
    bench = spec.Bench()
    config = bench.config(bench.workload(CELL)["config"])
    mode = config["modes"]["train"]
    ref = bench.reference(config)
    tree = from_classes(config["classes"])
    batch, hw = int(mode["training"]["batch_size"]), tuple(mode["transform"]["resize"])
    u = geometry.unit(batch, hw, tree, ref, mode["model"], train=True)
    seen = []
    real = ref.attention

    def record(q, k, v):
        seen.append(tuple(q.shape))
        assert k.shape == v.shape == q.shape
        return real(q, k, v)

    monkeypatch.setattr(ref, "attention", record)
    model = ref.build(mode["model"], tree).eval()  # train-mode BN takes no batch of 1
    with torch.no_grad():
        model(torch.zeros(batch, 3, *hw, device="meta"), with_train_heads=True)
    metric = bench.metric_reader("global_attention_roofline.train")
    vit = metric.listed(bench)
    assert vit == metric.constants(config) == (24, 16, 64, 16)
    assert [tuple(b) for b in metric.blocks(u, vit)] == seen == [(1, 16, N, 64)] * 24
    fwd, bwd = metric.forward(u, vit), metric.backward(u, vit)
    assert len(fwd) == len(bwd) == 24
    assert fwd[0] == {"bytes": 4 * 16 * N * 64 * 2, "flops": 4 * 16 * N * N * 64,
                      "flops_per_s": peaks.BF16_FLOPS}
    assert bwd[0] == {"bytes": 8 * 16 * N * 64 * 2, "flops": 8 * 16 * N * N * 64,
                      "flops_per_s": peaks.BF16_FLOPS}
    assert [k.launches(u) for k in metric.kernels(vit).values()] == [fwd, bwd]
    # 4·N²·C = 68.8 GFLOP a block's forward (C = 1024), the backward twice that
    assert abs(fwd[0]["flops"] - 68.75e9) < 0.01e9 and bwd[0]["flops"] == 2 * fwd[0]["flops"]


def test_cells_of_different_vit_constants_raise_rather_than_read_one_at_the_other(tmp_path):
    """A unit does not say which configuration ran it: a second listed cell
    whose configuration gives other ViT constants is an error."""
    import copy
    import json

    bench = spec.Bench()
    s = copy.deepcopy(bench.spec)
    for c in s["configs"]:
        c["file"] = str(spec.ROOT / c["file"])
    config = dict(bench.config("vitl16-3level"), depth=12)
    (tmp_path / "vit12.json").write_text(json.dumps(config))
    s["configs"].append(dict(s["configs"][-1], name="vit12", file="vit12.json"))
    s["workloads"].append({"name": "vit12.train-1024", "config": "vit12"})
    metric = bench.metric_reader("global_attention_roofline.train")
    next(m for m in s["per_layer"] if m["name"] == metric.NAME)["workloads"].append(
        "vit12.train-1024")
    other = spec.Bench(tmp_path / "BENCHMARK.json", spec=s)
    with pytest.raises(ValueError, match="ViT constants"):
        metric.listed(other)
