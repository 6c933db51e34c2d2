"""CPU tests of the harness's arithmetic: kernel counts against the least
times ``PERF.md`` §6 records, the layer shapes read from a reference pass,
the device's busy and idle time, the FLOP count, the seeded weights'
scales and the reference optimizer's update.

    python -m pytest hbench/tests -q
"""

import math
import types

import pytest
import torch
from torch import nn

from hbench.core import flops, geometry, kernelwork, peaks, profiling, spec, weights
from hbench.reference import model as resnet_reference
from hbench.reference.train import param_setting
from hbench.reference.tree import from_classes

KERNELS = spec.Bench().kernels()
RESNET = {"depth": 50, "output_stride": 8}  # with the sep-ASPP head's default widths


def unit(batch, hw, levels, valid_share=1.0, logits_bytes=4):
    tree = from_classes({"coarse_to_fine_map": [[0, levels[0] - 1]]})
    u = geometry.unit(batch, hw, tree, resnet_reference, RESNET, logits_bytes=logits_bytes)
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


class Depthwise(nn.Module):
    """Depthwise 3x3s written three ways, and convolutions that are not."""

    def __init__(self):
        super().__init__()
        self.stem = nn.Conv2d(3, 8, 3, stride=2, padding=1)
        self.dw = nn.Conv2d(8, 8, 3, padding=1, groups=8)
        self.dw_dilated = nn.Parameter(torch.zeros(8, 1, 3, 3))
        self.dw_1x1 = nn.Conv2d(8, 8, 1, groups=8)
        self.grouped = nn.Conv2d(8, 8, 3, padding=1, groups=4)
        self.head = nn.Conv2d(8, 5, 1)

    def forward(self, x, with_train_heads=True):
        y = self.dw(self.stem(x))
        y = torch.nn.functional.conv2d(y, self.dw_dilated, padding=3, dilation=3, groups=8)
        out = {"logits": self.head(self.grouped(self.dw_1x1(y)))}
        if with_train_heads:
            out["aux"] = self.dw(y)
        return out


def test_the_depthwise_shapes_come_from_the_reference_pass():
    def build(model_cfg, tree):
        with torch.device("meta"):
            return Depthwise()

    ref = types.SimpleNamespace(build=build, __file__="depthwise-test")
    tree = from_classes({"coarse_to_fine_map": [[0, 2], [3, 4]]})
    u = geometry.unit(2, (32, 40), tree, ref, {}, train=False)
    assert u["hw4"] == (16, 20)
    assert u["depthwise"] == [(2, 16, 20, 8, 1), (2, 16, 20, 8, 3)]
    assert geometry.unit(2, (32, 40), tree, ref, {}, train=True)["depthwise"][-1] == \
        (2, 16, 20, 8, 1)


def test_the_sep_aspp_units_list_its_five_depthwise_convolutions():
    tree = from_classes({"coarse_to_fine_map": [[0, 8], [9, 12]]})
    u = geometry.unit(2, (769, 769), tree, resnet_reference, dict(RESNET, depth=101),
                      train=True, valid=7)
    assert u["hw4"] == (193, 193) and u["valid"] == 7 and u["levels"] == [13, 2]
    assert u["depthwise"] == [(2, 97, 97, 2048, 12), (2, 97, 97, 2048, 24),
                              (2, 97, 97, 2048, 36), (2, 193, 193, 560, 1),
                              (2, 193, 193, 512, 1)]
    assert len(KERNELS["depthwise3x3"].launches(u)) == 2
    assert len(KERNELS["depthwise3x3_dilated"].launches(u)) == 3


class Blocks(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(2048, 256)
        self.fc2 = nn.Linear(256, 256)
        self.norm = nn.LayerNorm(256)
        self.norm_last = nn.LayerNorm(256)


def test_seeded_weights_draw_matrices_at_lecun_scale_and_residual_last_at_a_tenth():
    with torch.device("meta"):
        net = Blocks()
    sd = weights.make(net, 5, "cpu", residual_last=("fc2.", "norm_last."))
    assert sd["fc1.weight"].std().item() == pytest.approx(2048 ** -0.5, rel=0.02)
    assert sd["fc2.weight"].std().item() == pytest.approx(0.1 * 256 ** -0.5, rel=0.02)
    assert sd["fc1.bias"].std().item() == pytest.approx(0.1, rel=0.2)
    assert 0.5 <= sd["norm.weight"].min() and sd["norm.weight"].max() <= 1.5
    assert 0.05 <= sd["norm_last.weight"].min() and sd["norm_last.weight"].max() <= 0.15
    same = weights.make(net, 5, "cpu")
    assert torch.equal(same["fc1.weight"], sd["fc1.weight"])
    assert torch.equal(same["fc2.weight"] * 0.1, sd["fc2.weight"])


def test_weight_decay_skips_only_tensors_under_two_dimensions():
    training = {"lr": 0.1, "weight_decay": 0.01, "wd_skip_norm_bias": True,
                "backbone_lr_scale": 0.5}
    assert param_setting("backbone.conv.weight", torch.zeros(4, 4, 3, 3), training) == (0.05, 0.01)
    assert param_setting("head.fc.weight", torch.zeros(4, 8), training) == (0.1, 0.01)
    assert param_setting("head.norm.weight", torch.zeros(8), training) == (0.1, 0.0)
    assert param_setting("head.fc.weight", torch.zeros(8), dict(training, wd_skip_norm_bias=False)) \
        == (0.1, 0.01)


def test_the_reference_sgd_update_steps_as_torch_sgd():
    sgd = spec.Bench().optimizer("sgd")
    training = {"lr": 0.1, "momentum": 0.9, "weight_decay": 0.01}
    gen = torch.Generator().manual_seed(0)
    mine = {"w": torch.randn(4, 3, generator=gen), "b": torch.randn(3, generator=gen)}
    theirs = {k: v.clone().requires_grad_() for k, v in mine.items()}
    opt = torch.optim.SGD(theirs.values(), lr=0.1, momentum=0.9, weight_decay=0.01)
    state = {}
    for step in range(3):
        grads = {k: torch.randn(v.shape, generator=gen) for k, v in mine.items()}
        sgd.update(mine, grads, state, training, step)
        for k, p in theirs.items():
            p.grad = grads[k].clone()
        opt.step()
    for k in mine:
        assert torch.allclose(mine[k], theirs[k].detach(), rtol=0, atol=1e-6)
