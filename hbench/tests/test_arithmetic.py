"""CPU tests of the harness's arithmetic: kernel counts against the least
times ``PERF.md`` §6 records, percentiles with failures, the open-loop
schedule, the device's busy and idle time, and the FLOP count.

    python -m pytest hbench/tests -q
"""

import math

import numpy as np
import pytest
import torch
from torch import nn

from hbench.core import flops, geometry, kernelwork, peaks, profiling, spec
from hbench.reference.tree import from_classes

KERNELS = spec.Bench().kernels()


def unit(batch, hw, levels, valid_share=1.0, logits_bytes=4):
    tree = from_classes({"coarse_to_fine_map": [[0, levels[0] - 1]]})
    u = geometry.unit(batch, hw, tree, {}, logits_bytes=logits_bytes)
    u["levels"] = list(levels)
    u["valid"] = round(valid_share * batch * hw[0] * hw[1])
    return u


def least_ms(name, u):
    return sum(kernelwork.launch_seconds(w) for w in KERNELS[name].launches(u)) * 1e3


# PERF.md §6: (kernel, batch, input size, levels, valid share, logits bytes, least ms)
SECTION_6 = [
    ("depthwise3x3", 8, (512, 512), (9, 4), 1.0, 4, 0.1678),  # [8,128,128,560] + [...,512]
    ("depthwise3x3", 2, (769, 769), (9, 4, 2), 1.0, 4, 0.0954),  # config 4: [2,193,193,.]
    ("depthwise3x3", 4, (1024, 1024), (9, 4, 2), 1.0, 4, 0.3355),  # config 5: [4,256,256,.]
    ("depthwise3x3_dgrad", 8, (512, 512), (9, 4), 1.0, 4, 0.1678),
    ("depthwise3x3_dgrad", 2, (769, 769), (9, 4, 2), 1.0, 4, 0.0954),
    ("depthwise3x3_wgrad", 8, (512, 512), (9, 4), 1.0, 4, 0.1678),
    ("depthwise3x3_wgrad", 2, (769, 769), (9, 4, 2), 1.0, 4, 0.0954),
    ("upsample_argmax", 8, (512, 512), (9, 4), 1.0, 4, 0.0070),  # [8,13,128,128] f32
    ("upsample_argmax", 8, (512, 512), (9, 4), 1.0, 2, 0.0060),  # bf16 logits
    ("upsample_argmax", 4, (1024, 1024), (9, 4, 2), 1.0, 4, 0.0197),  # [4,15,256,256]
    ("upsample_argmax", 4, (1024, 1024), (9, 4, 2), 1.0, 2, 0.0174),
    # the fused loss: MUFU-bound, valid label pixels only (about 2 % ignored:
    # the shares that give the 84.3 M and 111.0 M results §6 counted)
    ("hiera2_fused_fwd", 8, (512, 512), (9, 4), 0.9804, 4, 0.0202),
    ("hiera2_fused_bwd", 8, (512, 512), (9, 4), 0.9802, 4, 0.0265),
    # RMI: 60 f32 maps of 512^2 (config 3: batch 4, 9 + 4 + 2) and 30 of 769^2
    ("rmi_gram18", 4, (512, 512), (9, 4, 2), 1.0, 4, 0.0376),
    ("rmi_residual_gram", 4, (512, 512), (9, 4, 2), 1.0, 4, 0.0587),
    ("rmi_grad_maps", 4, (512, 512), (9, 4, 2), 1.0, 4, 0.0564),
    ("rmi_gram18_fast", 2, (769, 769), (9, 4, 2), 1.0, 4, 0.0424),
    ("rmi_residual_gram_fast", 2, (769, 769), (9, 4, 2), 1.0, 4, 0.0424),
    ("rmi_grad_maps_fast", 2, (769, 769), (9, 4, 2), 1.0, 4, 0.0636),
]


@pytest.mark.parametrize("name,batch,hw,levels,valid,lb,want", SECTION_6,
                         ids=[f"{r[0]}-{r[1]}x{r[2][0]}-{r[5]}B" for r in SECTION_6])
def test_kernel_counts_reproduce_section_6(name, batch, hw, levels, valid, lb, want):
    got = least_ms(name, unit(batch, hw, levels, valid, lb))
    assert abs(got - want) <= 1e-4  # within a unit of §6's fourth decimal


def test_every_kernel_file_names_its_counter_and_device_functions():
    assert len(KERNELS) >= 12
    for name, mod in KERNELS.items():
        module, attr = mod.COUNTER
        assert module.startswith("seghiero_torch.ops.") and attr.endswith("launches"), name
        assert mod.NAMES and all(isinstance(n, str) for n in mod.NAMES), name


def test_roofline_is_least_time_over_device_time():
    u = unit(8, (512, 512), (9, 4))
    trace = {"launches": {"depthwise3x3": 2, "upsample_argmax": 1}, "geos": [u],
             "device_seconds": {"void seghiero::dw3x3_fwd_kernel<bf16>": 4e-4,
                                "upsample_argmax_kernel<float>": 2e-5, "cudnn_conv": 1.0}}
    least = (least_ms("depthwise3x3", u) + least_ms("upsample_argmax", u)) * 1e-3
    assert kernelwork.roofline(trace, KERNELS) == pytest.approx(100 * least / 4.2e-4)
    trace["launches"] = {}
    assert kernelwork.roofline(trace, KERNELS) is None


def test_idle_share_of_made_up_intervals():
    device = [("k1", 0.0, 10.0), ("k2", 5.0, 20.0), ("copy", 30.0, 40.0), ("k3", 90.0, 120.0)]
    cpu = [("hbench::step", 0.0, 60.0), ("aten::item", 22.0, 29.0),
           ("hbench::loader_wait", 60.0, 95.0)]
    out = profiling.read(device, cpu, 0.0, 100.0)
    assert out["busy_s"] == pytest.approx(40e-6)  # [0,20] + [30,40] + [90,100]
    assert out["window_s"] == pytest.approx(100e-6)
    # idle [20,30] (mid 25: in step, in aten::item) and [40,90] (mid 65: loader_wait)
    assert [g[0] for g in out["breakdown"]["idle_gaps"]] == ["loader_wait", "step/aten::item"]
    assert out["breakdown"]["idle_gaps"][0][1] == pytest.approx(50e-6)
    assert out["breakdown"]["device_ops"][0] == ["k2", pytest.approx(15e-6)]


class TinyNet(nn.Module):
    """A 3x3 stem at stride 2, a depthwise 3x3 (dilation 2) and a 1x1."""

    def __init__(self):
        super().__init__()
        self.a = nn.Conv2d(3, 8, 3, stride=2, padding=1, bias=False)
        self.d = nn.Conv2d(8, 8, 3, padding=2, dilation=2, groups=8, bias=False)
        self.b = nn.Conv2d(8, 4, 1, bias=False)

    def forward(self, x, with_train_heads=True):
        return {"logits": self.b(torch.relu(self.d(torch.relu(self.a(x)))))}


def test_flop_count_of_a_tiny_net_matches_a_hand_count():
    with torch.device("meta"):
        net = TinyNet()
    hw = (16, 20)
    px = (hw[0] // 2) * (hw[1] // 2)
    a = 2 * 3 * 8 * 9 * px
    d = 2 * 8 * 9 * px  # one input channel a filter
    b = 2 * 8 * 4 * px
    assert flops.per_image(net, hw, train=False) == a + d + b
    # backward: every weight gradient, the input gradients of d and b only
    assert flops.per_image(net, hw, train=True) == (a + d + b) + a + 2 * d + 2 * b


def test_least_seconds_takes_the_longest_bound():
    assert peaks.least_seconds(3.35e12) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 989e12, peaks.BF16_FLOPS) == pytest.approx(1.0)
    assert peaks.least_seconds(0, mufu=132 * 16 * 1.98e9) == pytest.approx(1.0)
    assert math.isclose(peaks.least_seconds(1.0, 1.0), 1 / 3.35e12)
