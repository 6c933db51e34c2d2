"""Pins of what the harness derives from a configuration, taken on the
harness as it stood before the reference model, its optimizer and the
kernels' launch shapes were found by the configuration: the seeded state
dict of each configuration at two seeds, each cell's per-launch kernel
works at its full size, and each cell's FLOPs per image. A change that
moves any of them moves the readings of the cells that are pinned.

    python -m pytest hbench/tests -q
"""

import hashlib
import json

import pytest
import torch

from hbench.core import flops, geometry, spec, weights
from hbench.reference.tree import from_classes

BENCH = spec.Bench()
SEEDS = (1, 3_000_000_019)

WEIGHTS = {
    "r101-3level/1": "8fff72c1ab1a374ab485eb6fca04111118aea34bed20f76e27240424adb7d4b6",
    "r101-3level/3000000019": "76c1606b8fd5e03fead81791a164f2ddfb95dc40476798d4e80e708be602c15d",
    "r50-2level/1": "a2563237ecd3add27257d6386eb580265c8edb078d9556e5c5e9546ad248ddea",
    "r50-2level/3000000019": "993a8ae9d38c9c19bdae832ec78ea2216ce92e24333ea055fd66d162b2ae1f0e",
}
WORKS = {
    "r101-3level.train-769": "c009604d167fdf865bda50e7b68a50dbb6c9d383307e687c6126bbdb4b4de256",
    "r50-2level.train-files": "f98f24cf411f727934c4e56187b9dbc1524f0a5da5b0eaf880429be35f5e4cbb",
    "r101-3level.infer-1024": "a284bd684095f0e0f30cb87312b081c726959debed69c8aa43b4b4ea783af2be",
}
FLOPS = {
    "r101-3level.train-769": 3151620320544.0,
    "r50-2level.train-files": 907301879808.0,
    "r101-3level.infer-1024": 1676874350592.0,
}


def state_hash(sd):
    h = hashlib.sha256()
    for k in sorted(sd):
        v = sd[k].detach().cpu().contiguous()
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def cell(name):
    """(reference module, model config, tree, batch, input size, training)
    of a cell at its full size, as its driver reads them."""
    w = BENCH.workload(name)
    config = BENCH.config(w["config"])
    traffic = BENCH.traffic(w["traffic"])
    train = BENCH.driver(traffic["driver"]).Driver.kind == "train"
    mode = config["modes"]["train" if train else "infer"]
    batch = int(mode["training"]["batch_size"]) if train else int(traffic["batch"])
    return (BENCH.reference(config), mode["model"], from_classes(config["classes"]), batch,
            tuple(mode["transform"]["resize"]), train)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("key", sorted(WEIGHTS))
def test_seeded_state_dict_is_pinned(key):
    name, seed = key.split("/")
    config = BENCH.config(name)
    ref = BENCH.reference(config)
    model = ref.build(config["modes"]["train"]["model"], from_classes(config["classes"]))
    assert state_hash(weights.make(model, int(seed), "cpu", ref.RESIDUAL_LAST)) == WEIGHTS[key]


@pytest.mark.parametrize("name", sorted(WORKS))
def test_kernel_works_of_each_launch_are_pinned(name):
    ref, model_cfg, tree, batch, hw, train = cell(name)
    u = geometry.unit(batch, hw, tree, ref, model_cfg, train=train, valid=batch * hw[0] * hw[1])
    works = {k: m.launches(u) for k, m in BENCH.kernels().items()}
    assert hashlib.sha256(json.dumps(works, sort_keys=True).encode()).hexdigest() == WORKS[name]


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_flops_per_image_are_pinned(name):
    ref, model_cfg, tree, _, hw, train = cell(name)
    assert flops.per_image(ref.build(model_cfg, tree), hw, train) == FLOPS[name]

