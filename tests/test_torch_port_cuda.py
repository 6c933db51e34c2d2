"""Card-only: the port's CUDA kernels against their plain PyTorch versions.

Skips with a reason where no CUDA card is visible (the kernels have no CPU
mode). This file imports nothing of JAX, so it also runs on a machine
without it; there, skip the JAX-pinning conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_cuda.py
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from seghiero_torch.hierarchy import Hierarchy
from seghiero_torch.losses.fast import FastHieraTripletLoss
from seghiero_torch.losses.hiera import prepare_targets_two_level
from seghiero_torch.models.heads import DepthwiseConv
from seghiero_torch.ops import depthwise as port_dw
from seghiero_torch.ops import hiera2_fused as port_fused
from seghiero_torch.ops import rmi_gram as port_rg
from seghiero_torch.ops import upsample_argmax as port_ua


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# shapes that cut the depthwise kernels' tiles raggedly (32-row bands,
# 32-column tiles at 128-byte channel chunks): H and W of 1, of a tile and
# one past it, config 4's W = 193, C of 1 … 560 (ragged chunks, vectors
# narrower than 16 bytes), B of 1 to 3
DW_RAGGED = ((1, 1, 1, 1), (2, 1, 33, 3), (3, 32, 1, 8), (1, 33, 32, 77),
             (2, 32, 33, 130), (1, 33, 193, 560), (3, 5, 193, 8), (2, 64, 65, 560),
             (1, 31, 193, 130))


def _randn_misaligned(shape, gen, dev, dtype):
    """A contiguous tensor whose data starts one element into its storage,
    so no vector wider than one element is aligned (the vec = 1 paths)."""
    n = int(np.prod(shape))
    t = torch.randn((n + 1,), generator=gen, device=dev).to(dtype)[1:].view(shape)
    assert t.is_contiguous() and t.data_ptr() % (2 * t.element_size()) != 0
    return t


@pytest.mark.gpu
def test_cuda_kernels_equal_plain_versions():
    """Card-only: each CUDA kernel against its plain version, bit for bit,
    at odd sizes (vector-width fallbacks, partial blocks, ragged tiles,
    misaligned pointers) and one serving shape; a non-contiguous input
    raises instead of being copied."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((2, 13, 11, 3), (1, 9, 20, 130), (3, 17, 5, 6), (2, 128, 128, 560),
                      *DW_RAGGED):
            for misaligned in (False, True):
                if misaligned:
                    x = _randn_misaligned(shape, gen, dev, dtype)
                else:
                    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
                k9 = torch.randn((9, shape[-1]), generator=gen, device=dev).to(dtype)
                before = port_dw.launches
                got = port_dw.depthwise3x3(x, k9)
                assert port_dw.launches == before + 1
                assert torch.equal(got, port_dw.depthwise3x3_plain(x, k9)), (dtype, shape,
                                                                              misaligned)
        # the decode's blocks take 128 low-res pixels of a row: widths of 1,
        # one past a block (131, 3 levels) and two past (130), h of 1
        for shape, slices in (((2, 13, 6, 10), [(0, 9), (9, 13)]),
                              ((1, 15, 7, 9), [(0, 9), (9, 13), (13, 15)]),
                              ((2, 15, 3, 131), [(0, 9), (9, 13), (13, 15)]),
                              ((2, 13, 5, 130), [(0, 9), (9, 13)]),
                              ((3, 15, 1, 7), [(0, 9), (9, 13), (13, 15)]),
                              ((2, 13, 6, 1), [(0, 9), (9, 13)]),
                              ((8, 13, 128, 128), [(0, 9), (9, 13)])):
            lo = torch.randn(shape, generator=gen, device=dev).to(dtype)
            lo[:, 4] = lo[:, 2]
            before = port_ua.launches
            got = port_ua.upsample_argmax(lo, slices)
            assert port_ua.launches == before + 1 and len(got) == len(slices)
            for g, w in zip(got, port_ua.upsample_argmax_plain(lo, slices)):
                assert torch.equal(g, w), (dtype, shape)
    x = torch.randn((1, 8, 8, 4), device=dev)
    with pytest.raises(ValueError, match="refusing to copy"):
        port_dw.depthwise3x3(x.transpose(1, 2), torch.randn((9, 4), device=dev))
    with pytest.raises(ValueError, match="refusing to copy"):
        port_ua.upsample_argmax(torch.randn((1, 3, 4, 4), device=dev).transpose(2, 3), [(0, 3)])


@pytest.mark.gpu
def test_depthwise_gradient_kernels_equal_plain_versions():
    """Card-only: the input gradient (#1b, bit for bit: the forward kernel
    with reversed taps) and the weight gradient (#2, within 1e-5·Σ|x·g| per
    entry: another summation order; the same bits twice) at odd sizes — C
    not a multiple of 8, H and W not multiples of the kernels' 32-row bands
    and 32-column tiles, misaligned pointers — and the weight gradient's C
    entry refuses a scratch that does not match the shape."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((2, 13, 11, 3), (1, 9, 37, 130), (3, 17, 5, 6), (2, 33, 70, 77),
                      *DW_RAGGED):
            for misaligned in (False, True):
                make = _randn_misaligned if misaligned else (
                    lambda s, gen, dev, dt: torch.randn(s, generator=gen, device=dev).to(dt))
                x, g = make(shape, gen, dev, dtype), make(shape, gen, dev, dtype)
                k9 = torch.randn((9, shape[-1]), generator=gen, device=dev).to(dtype)
                before = (port_dw.dgrad_launches, port_dw.wgrad_launches)
                dx = port_dw.depthwise3x3_dgrad(g, k9)
                dk = port_dw.depthwise3x3_wgrad(x, g)
                assert (port_dw.dgrad_launches, port_dw.wgrad_launches) == (before[0] + 1,
                                                                            before[1] + 1)
                case = (dtype, shape, misaligned)
                assert torch.equal(dx, port_dw.depthwise3x3_plain(g, k9.flip(0))), case
                want = port_dw.depthwise3x3_wgrad_plain(x, g)
                mag = port_dw.depthwise3x3_wgrad_plain(x.float().abs(), g.float().abs())
                assert dk.dtype == torch.float32 and dk.shape == want.shape
                assert ((dk - want).abs() <= 1e-5 * mag + 1e-30).all(), case
                assert torch.equal(dk, port_dw.depthwise3x3_wgrad(x, g)), case  # deterministic
    # the C entry checks the scratch rows against the shape
    B, H, W, C = 2, 33, 70, 64
    x = torch.randn((B, H, W, C), device=dev)
    lib = port_dw._build.library()
    P = port_dw.wgrad_partials(B, H, W)
    partial = torch.empty((P + 1, 9, C), device=dev)
    dk = torch.empty((9, C), device=dev)
    for rows in (P - 1, P + 1):
        err = lib.seghiero_dw3x3_wgrad(x.data_ptr(), x.data_ptr(), partial.data_ptr(),
                                       dk.data_ptr(), B, H, W, C, 0, 4, rows, dev.index or 0,
                                       torch.cuda.current_stream(dev).cuda_stream)
        assert err != 0, rows


@pytest.mark.gpu
def test_depthwise_weight_gets_a_gradient_on_the_card():
    """Card-only: the autograd Function carries the gradient through the
    kernels (the ctypes launch alone has no grad_fn)."""
    dev = _card()
    conv = DepthwiseConv(12, 3, 1, use_kernel=True).to(dev, memory_format=torch.channels_last)
    x = torch.randn(2, 12, 9, 10, device=dev).to(memory_format=torch.channels_last)
    x.requires_grad_()
    ref = DepthwiseConv(12, 3, 1, use_kernel=False).to(dev)
    ref.load_state_dict(conv.state_dict())
    before = (port_dw.launches, port_dw.dgrad_launches, port_dw.wgrad_launches)
    y = conv(x)
    y.square().sum().backward()
    after = (port_dw.launches, port_dw.dgrad_launches, port_dw.wgrad_launches)
    assert after == tuple(b + 1 for b in before)
    assert conv.weight.grad is not None and conv.weight.grad.abs().sum() > 0
    x2 = x.detach().clone().requires_grad_()
    ref(x2).square().sum().backward()
    torch.testing.assert_close(conv.weight.grad, ref.weight.grad, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(x.grad, x2.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_dilated_depthwise_kernel_equals_plain_version():
    """Card-only: the dilated forward (#9) against its plain version, bit
    for bit (the same f32 order, no FMA; the padding terms it skips are ±0),
    at the ASPP's dilations on the served stride-8 map [4,128,128,2048] and
    config 4's odd [2,97,97,2048], and at ragged sizes (d ≥ H, vectors
    narrower than 16 bytes, misaligned pointers); one launch counted a call,
    none for a CPU tensor; the model's route takes it under inference only."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = [(shape, d) for shape in ((4, 128, 128, 2048), (2, 97, 97, 2048))
             for d in (2, 12, 24, 36)]
    cases += [(shape, d) for shape in DW_RAGGED for d in (2, 12, 36)]
    for dtype in (torch.float32, torch.bfloat16):
        for shape, d in cases:
            for misaligned in (False, True) if shape[-1] < 2048 else (False,):
                if misaligned:
                    x = _randn_misaligned(shape, gen, dev, dtype)
                else:
                    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
                k9 = torch.randn((9, shape[-1]), generator=gen, device=dev).to(dtype)
                before = port_dw.dilated_launches
                got = port_dw.depthwise3x3_dilated_forward(x, k9, d)
                assert port_dw.dilated_launches == before + 1
                assert torch.equal(got, port_dw.depthwise3x3_dilated_plain(x, k9, d)), (
                    dtype, shape, d, misaligned)
    before = port_dw.dilated_launches
    port_dw.depthwise3x3_dilated_forward(torch.randn(1, 9, 9, 4), torch.randn(9, 4), 12)
    assert port_dw.dilated_launches == before
    with pytest.raises(ValueError, match="refusing to copy"):
        port_dw.depthwise3x3_dilated_forward(torch.randn((1, 8, 8, 4), device=dev).transpose(1, 2),
                                             torch.randn((9, 4), device=dev), 2)

    conv = DepthwiseConv(64, 3, 12, use_kernel=True).to(dev, memory_format=torch.channels_last)
    x = torch.randn(2, 64, 30, 20, device=dev).to(memory_format=torch.channels_last)
    counts = (port_dw.launches, port_dw.dilated_launches)
    with torch.inference_mode():
        y = conv(x)
    assert (port_dw.launches, port_dw.dilated_launches) == (counts[0], counts[1] + 1)
    y_grad = conv(x.clone().requires_grad_())  # autograd needs a backward: cuDNN
    assert (port_dw.launches, port_dw.dilated_launches) == (counts[0], counts[1] + 1)
    torch.testing.assert_close(y, y_grad.detach(), rtol=1e-5, atol=1e-5)


CLASSES = {"coarse_to_fine_map": [[0, 3], [4, 6], [7], [8]],
           "fine_names": {i: f"f{i}" for i in range(9)}}
# hierarchies beyond config 2's, each with the (B, h, w) it runs at: 18 + 2
# classes whose groups are not contiguous (the second range overwrites part
# of the first, so fine_to_coarse is not sorted); the 150 + 15 of
# configs/example-many-classes.yaml; one group holding all fine classes
# but one
FUSED_CASES = (
    (CLASSES, ((2, 5, 7), (1, 9, 70), (3, 16, 33))),
    ({"coarse_to_fine_map": [[0, 17], [4, 9]], "fine_names": {i: f"f{i}" for i in range(18)}},
     ((2, 5, 7), (1, 13, 35))),
    ({"coarse_to_fine_map": [[10 * g, 10 * g + 9] for g in range(15)],
      "fine_names": {i: f"f{i}" for i in range(150)}}, ((2, 6, 10), (1, 5, 33))),
    ({"coarse_to_fine_map": [[0, 10], [11]], "fine_names": {i: f"f{i}" for i in range(12)}},
     ((1, 9, 70),)),
)


@pytest.mark.gpu
def test_fused_loss_kernels_equal_plain_versions():
    """Card-only: the fused forward (#4: six sums within 1e-5 relative) and
    backward (#5: d lo within rtol 2e-4, atol 1e-7) against their plain
    versions for the hierarchies of ``FUSED_CASES``, at odd sizes (h, w not
    multiples of the kernels' 2- and 4-row, 32-column tiles), with ignore
    pixels, saturated logits and planted ties (l_f = l_parent on even rows;
    two children of a group equal on odd rows); two runs give the same
    bits."""
    dev = _card()
    rng = np.random.default_rng(0)
    for classes, shapes in FUSED_CASES:
        h = Hierarchy.from_class_config(classes)
        nf, nc = h.n_fine, h.n_coarse
        f2c = np.asarray(h.fine_to_coarse)
        pair = next(ids for ids in h.fine_by_coarse if len(ids) >= 2)
        for B, hh, ww in shapes:
            case = (nf, nc, B, hh, ww)
            lo = (rng.standard_normal((B, nf + nc, hh, ww)) * 3).astype(np.float32)
            lo = np.where(rng.random(lo.shape) < 0.03, np.sign(lo) * 40.0, lo).astype(np.float32)
            for f in range(nf):
                lo[:, f, ::2] = lo[:, nf + f2c[f], ::2]
            lo[:, pair[1], 1::2] = lo[:, pair[0], 1::2]
            labels = rng.integers(0, nf, (B, 4 * hh, 4 * ww)).astype(np.int32)
            labels[:, :3, :5] = 255
            lo_t = torch.from_numpy(lo).to(dev)
            tf, tc = prepare_targets_two_level(torch.from_numpy(labels).to(dev), h)
            tf, tc = tf.contiguous(), tc.contiguous()
            before = (port_fused.fwd_launches, port_fused.bwd_launches)
            got = port_fused.fused_hiera2_sums_kernel(lo_t, tf, tc, h)
            want = port_fused.fused_hiera2_sums_plain(lo_t, tf, tc, h)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6, msg=str(case))
            # the cotangents the loss assembly passes (losses/fast.py), so the
            # gradient has the scale the tolerance was set for
            nvf, nvc, n = float(want[2]), float(want[3]), labels.size
            g = torch.tensor([5 / (max(nvf, 1) * nf), 5 / (max(nvc, 1) * nc), 0.0, 0.0,
                              1 / n, 1 / n], device=dev)
            dgot = port_fused.fused_hiera2_grad_kernel(lo_t, tf, tc, h, g)
            dwant = port_fused.fused_hiera2_grad_plain(lo_t, tf, tc, h, g)
            torch.testing.assert_close(dgot, dwant, rtol=2e-4, atol=1e-7, msg=str(case))
            assert (port_fused.fwd_launches, port_fused.bwd_launches) == (before[0] + 1,
                                                                          before[1] + 1)
            assert torch.equal(got, port_fused.fused_hiera2_sums_kernel(lo_t, tf, tc, h)), case
            assert torch.equal(dgot, port_fused.fused_hiera2_grad_kernel(lo_t, tf, tc, h, g)), case
            # unit cotangents: each d lo entry adds up to 64 weighted
            # per-pixel gradients of order 1 in another order than the plain
            # version, so the absolute tolerance is 64 f32 roundings at 1
            # (64 · 2^-24 ≈ 4e-6)
            g1 = torch.ones(6, device=dev)
            torch.testing.assert_close(port_fused.fused_hiera2_grad_kernel(lo_t, tf, tc, h, g1),
                                       port_fused.fused_hiera2_grad_plain(lo_t, tf, tc, h, g1),
                                       rtol=2e-4, atol=4e-6, msg=str(case))
    with pytest.raises(ValueError, match="refusing to copy"):
        port_fused.fused_hiera2_sums_kernel(lo_t.transpose(2, 3), tf, tc, h)
    with pytest.raises(ValueError, match="C channels"):
        port_fused.fused_hiera2_sums_kernel(lo_t[:, 1:].contiguous(), tf, tc, h)
    # the loss asked for the kernels on the card raises for labels that are
    # not 4x the logits, instead of taking the library path
    labels8 = torch.zeros((lo_t.shape[0], 8 * lo_t.shape[2], 8 * lo_t.shape[3]),
                          dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="pallas_fused_loss"):
        FastHieraTripletLoss(h, use_kernel=True)(0, None, None, lo_t, labels8)


def _rmi_maps(gen, dev, BC, H, W):
    """A one-hot-like map (0/1) and probabilities in (0, 1], [BC, H, W] f32."""
    la = (torch.rand((BC, H, W), generator=gen, device=dev) < 0.3).float()
    pr = torch.sigmoid(2 * torch.randn((BC, H, W), generator=gen, device=dev)) + 1e-6
    return la, pr


# the RMI kernels' shapes: the interior (H−4, W−4) of #6 and #8 one past
# (33, 257) or one short (63, 511) of their 32-row, 256-column tiles; all
# frame (4 × 4: no interior pixel) or mostly frame (an interior 1 pixel
# wide); the output (H−2, W−2) of #7 and #7f one past their 32 × 256 tiles
# (129 rows, 513 columns; 33, 257), one short (63 rows, 255 columns; 31,
# 255) or exactly one (32, 256), W−2 not a multiple of #7f's 16-pixel
# segments nor of #7's 4 columns a thread; config 4's width of 769 (rows not
# 16-byte aligned: #7 reads its staged rows at an offset); 65536 tiles of
# rows, past the 65535 row bands the earlier #7 launch took
RMI_SHAPES = ((3, 18, 20), (2, 37, 131), (1, 3, 3), (2, 70, 257), (4, 131, 40),
              (2, 4, 4), (1, 5, 300), (3, 300, 5), (2, 37, 261), (1, 67, 515),
              (1, 65, 259), (1, 35, 259), (1, 33, 257), (2, 34, 258), (2, 41, 769),
              (1, 32 * 65535 + 3, 3))


@pytest.mark.gpu
def test_rmi_gram_kernels_equal_plain_versions():
    """Card-only: the RMI kernels #6–#8 against their plain versions at small
    and ragged shapes (H−2 and W−2 one past, one short of or equal to #7's
    32-row, 256-column tiles; W < 256; several row tiles; rows of 769; the
    interior of #6 and #8, H−4 and W−4, one past or one short of their
    32-row, 256-column tiles; maps that are all or mostly their 2-pixel
    frame; 65536 row tiles): the Grams per entry
    within 1e-5·Σ|z_i·z_j| (for #7 with |y| bounded by |z_la| + |W|ᵀ·|z_pr|),
    d pr per pixel within 1e-5·Σ|P|·|z| (f32 sums in another order), and
    two runs give the same bits."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(3)
    for BC, H, W in RMI_SHAPES:
        la, pr = _rmi_maps(gen, dev, BC, H, W)
        w = torch.randn((BC, 9, 9), generator=gen, device=dev) * 0.3
        p = torch.randn((BC, 9, 18), generator=gen, device=dev)
        before = (port_rg.gram18_launches, port_rg.residual_launches, port_rg.grad_launches)
        g18, a, dpr = port_rg.gram18(la, pr), port_rg.residual_gram(la, pr, w), \
            port_rg.grad_maps(la, pr, p)
        assert (port_rg.gram18_launches, port_rg.residual_launches,
                port_rg.grad_launches) == tuple(b + 1 for b in before)
        mag = port_rg.gram18_plain(la.abs(), pr.abs())
        assert ((g18 - port_rg.gram18_plain(la, pr)).abs() <= 1e-5 * mag + 1e-30).all(), (H, W)
        yb = port_rg._views(la.abs()) + w.abs().mT @ port_rg._views(pr.abs())
        assert ((a - port_rg.residual_gram_plain(la, pr, w)).abs()
                <= 1e-5 * (yb @ yb.mT) + 1e-30).all(), (H, W)
        mag = port_rg.grad_maps_plain(la.abs(), pr.abs(), p.abs())
        assert ((dpr - port_rg.grad_maps_plain(la, pr, p)).abs() <= 1e-5 * mag + 1e-30).all()
        assert torch.equal(g18, port_rg.gram18(la, pr))
        assert torch.equal(a, port_rg.residual_gram(la, pr, w))
        assert torch.equal(dpr, port_rg.grad_maps(la, pr, p))
    with pytest.raises(ValueError, match="refusing to copy"):
        port_rg.gram18(la.transpose(1, 2), pr.transpose(1, 2))


@pytest.mark.gpu
def test_rmi_fast_kernels_equal_plain_versions():
    """Card-only: the bf16-view variants #6f–#8f (``rmi_precision: fast``)
    against their plain fast versions in f64 after the same roundings, at
    the shapes above and one 769-wide shape (config 4's: 767 output rows
    and columns, 765 interior ones): #6f and #8f within 1e-5 of the
    magnitude (their roundings are the same on both sides; f32 order
    only), #7f within 2e-5 (its residual y is also rounded from the tensor
    core's sum, which can fall on the other side of a bf16 boundary, and
    the tensor core adds y·yᵀ in its own order) and exactly symmetric; two
    runs give the same bits; non-contiguous or non-f32 maps raise instead
    of being copied."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(5)
    for BC, H, W in RMI_SHAPES + ((2, 41, 769),):
        la, pr = _rmi_maps(gen, dev, BC, H, W)
        w = torch.randn((BC, 9, 9), generator=gen, device=dev) * 0.3
        p = torch.randn((BC, 9, 18), generator=gen, device=dev)
        la64, pr64 = la.double(), pr.double()
        counts = ("gram18_fast_launches", "residual_fast_launches", "grad_fast_launches",
                  "gram18_launches", "residual_launches", "grad_launches")
        before = [getattr(port_rg, c) for c in counts]
        g18, a, dpr = (port_rg.gram18(la, pr, "fast"), port_rg.residual_gram(la, pr, w, "fast"),
                       port_rg.grad_maps(la, pr, p, "fast"))
        assert [getattr(port_rg, c) - b for c, b in zip(counts, before)] == [1, 1, 1, 0, 0, 0]
        want = port_rg.gram18_plain(la64, pr64, "fast")  # la, pr ≥ 0: its own magnitude
        assert ((g18.double() - want).abs() <= 1e-5 * want + 1e-30).all(), (H, W)
        r = port_rg.bf16_round
        yb = port_rg._views(r(la64)) + r(w.double()).abs().mT @ port_rg._views(r(pr64))
        want = port_rg.residual_gram_plain(la64, pr64, w.double(), "fast")
        assert ((a.double() - want).abs() <= 2e-5 * (yb @ yb.mT) + 1e-30).all(), (H, W)
        assert torch.equal(a, a.mT)
        want = port_rg.grad_maps_plain(la64, pr64, p.double(), "fast")
        mag = port_rg.grad_maps_plain(la64, pr64, p.double().abs(), "fast")
        assert ((dpr.double() - want).abs() <= 1e-5 * mag + 1e-30).all(), (H, W)
        assert torch.equal(g18, port_rg.gram18(la, pr, "fast"))
        assert torch.equal(a, port_rg.residual_gram(la, pr, w, "fast"))
        assert torch.equal(dpr, port_rg.grad_maps(la, pr, p, "fast"))
        # the bf16 views are not the f32 kernels' arithmetic
        assert not torch.equal(g18, port_rg.gram18(la, pr))
    with pytest.raises(ValueError, match="refusing to copy"):
        port_rg.gram18(la.transpose(1, 2), pr.transpose(1, 2), "fast")
    with pytest.raises(ValueError, match="expected f32"):
        port_rg.grad_maps(la, pr.to(torch.bfloat16), p, "fast")
    with pytest.raises(ValueError, match="refusing to copy"):
        port_rg.rmi_logdet_kernel_cmajor(la[None].transpose(2, 3), pr[None].transpose(2, 3),
                                         "fast")


@pytest.mark.gpu
def test_rmi_kernel_path_matches_the_materialized_op_on_the_card():
    """Card-only: the RMI term through kernels #6–#8 (``rmi_backend:
    pallas``) against the materialized op (``xla``), value and gradient, at
    JAX's kernel-vs-core tolerances (tests/test_rmi_gram_pallas.py: value
    rtol 2e-4, gradient rtol 5e-3 / atol 2e-5 at unit-scale maps)."""
    from seghiero_torch.losses.rmi import rmi_lower_bound_cmajor

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(4)
    B, C, H, W = 2, 3, 34, 26
    oh = torch.nn.functional.one_hot(torch.randint(0, C, (B, H, W), generator=gen, device=dev),
                                     C).permute(0, 3, 1, 2).float().contiguous()
    lg = torch.randn((B, C, H, W), generator=gen, device=dev)
    out = {}
    for backend in ("pallas", "xla"):
        x = lg.clone().requires_grad_()
        v = rmi_lower_bound_cmajor(oh, torch.sigmoid(x) + 1e-6, backend=backend)
        v.backward()
        out[backend] = (v.item(), x.grad)
    torch.testing.assert_close(out["pallas"][0], out["xla"][0], rtol=2e-4, atol=0)
    # the gradient of the mean over B·9 is 1/18 of the per-map half's
    torch.testing.assert_close(out["pallas"][1] * 18, out["xla"][1] * 18, rtol=5e-3, atol=2e-5)


# the Mix-FFN's depthwise convolutions of MiT-B5 at a 1024² image: each
# stage's grid at 4× its embed dim
MIT_DW = ((1, 256, 256, 256), (1, 128, 128, 512), (1, 64, 64, 1280), (1, 32, 32, 2048))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", MIT_DW)
def test_depthwise_kernels_at_the_mix_ffn_shapes(shape):
    """Card-only: #1 and #1b bit for bit against their plain versions, #2
    within 1e-5·Σ|x·g| per entry, in bf16 at the four Mix-FFN shapes."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    k9 = torch.randn((9, shape[-1]), generator=gen, device=dev).to(torch.bfloat16)
    assert torch.equal(port_dw.depthwise3x3_forward(x, k9), port_dw.depthwise3x3_plain(x, k9))
    assert torch.equal(port_dw.depthwise3x3_dgrad(g, k9),
                       port_dw.depthwise3x3_plain(g, k9.flip(0)))
    dk = port_dw.depthwise3x3_wgrad(x, g)
    want = port_dw.depthwise3x3_wgrad_plain(x, g)
    mag = port_dw.depthwise3x3_wgrad_plain(x.float().abs(), g.float().abs())
    assert ((dk - want).abs() <= 1e-5 * mag + 1e-30).all()


# (B, h, N, M, d): MiT-B5's four stages of a 1024² image at batch 1, B0's
# first stage at the graph tests' 64² (d = 32, 4 keys) and at 1024², and a
# shape whose queries and keys end in ragged tiles
ATTENTION_SHAPES = ((1, 1, 65536, 1024, 64), (1, 2, 16384, 1024, 64), (1, 5, 4096, 1024, 64),
                    (1, 8, 1024, 1024, 64), (2, 1, 256, 4, 32), (1, 1, 65536, 1024, 32),
                    (2, 3, 1000, 70, 64))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
def test_sr_attention_takes_a_fused_kernel_and_counts(dtype):
    """Card-only: ``sr_attention`` in bf16 runs the hand-written pair
    (``csrc/sr_attention.cu``) at MiT's shapes: every kernel of its forward
    and backward is the port's (``seghiero``, ``flash_fwd`` / ``flash_bwd``
    in its name), no PyTorch flash kernel runs and ``sdpa_launches`` stays,
    on contiguous operands and on MiT's strided views alike;
    in f32 it takes SDPA's memory-efficient kernels (``fmha_cutlass*``) and
    counts them in ``sdpa_launches``; never the math path's softmax. Output
    and q, k, v gradients match the plain path in f32 within 2e-2 of the
    largest (bf16 operands; 1e-4 in f32); one forward and one backward
    count a call."""
    from torch.profiler import ProfilerActivity, profile

    from seghiero_torch.ops import attention

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(5)
    shapes = ATTENTION_SHAPES if dtype == torch.bfloat16 else ((1, 1, 65536, 1024, 64),
                                                               (2, 5, 4096, 1024, 64))
    for i, (B, h, N, M, d) in enumerate(shapes):
        if i % 2:
            q, k, v = (torch.randn((B, h, n, d), generator=gen, device=dev).to(dtype)
                       .requires_grad_() for n in (N, M, M))
        else:  # MiT's layout: views of the q and kv projections' tokens
            q = torch.randn((B, N, h, d), generator=gen, device=dev).to(dtype).requires_grad_()
            kv = torch.randn((B, M, 2, h, d), generator=gen, device=dev).to(dtype)
            k, v = kv.requires_grad_().permute(2, 0, 3, 1, 4)
            q = q.transpose(1, 2)
        g = torch.randn((B, h, N, d), generator=gen, device=dev).to(dtype)
        # a first call outside the profile: the kernel library's build and
        # the libraries' first-use set-up stay out of the traced window
        torch.autograd.grad(attention.sr_attention(q, k, v), (q, k, v), g)
        torch.cuda.synchronize()
        before = (attention.launches, attention.bwd_launches, attention.sdpa_launches)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = attention.sr_attention(q, k, v)
            grads = torch.autograd.grad(out, (q, k, v), g)
            torch.cuda.synchronize()
        sdpa = 0 if dtype == torch.bfloat16 else 1
        assert (attention.launches, attention.bwd_launches, attention.sdpa_launches) == (
            before[0] + 1, before[1] + 1, before[2] + sdpa), (B, h, N, M, d)
        names = {e.name for e in prof.events() if e.device_type.name == "CUDA"}
        if dtype == torch.bfloat16:
            assert names and all("seghiero" in n and ("flash_fwd" in n or "flash_bwd" in n)
                                 for n in names), sorted(names)
            assert any("flash_fwd" in n for n in names) and any("flash_bwd" in n for n in names)
            assert not any("pytorch_flash" in n for n in names), sorted(names)
        else:
            assert all(any(w in n for n in names) for w in ("fmha_cutlassF", "fmha_cutlassB")), \
                sorted(names)[:20]
        assert not any("softmax" in n.lower() for n in names), sorted(names)[:20]
        q2, k2, v2 = (t.detach().float().requires_grad_() for t in (q, k, v))
        ref = attention.sr_attention_plain(q2, k2, v2)
        ref.backward(g.float())
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        assert (out.float() - ref).abs().max() <= tol * ref.abs().max(), (B, h, N, M, d)
        for got, t in zip(grads, (q2, k2, v2)):
            assert (got.float() - t.grad).abs().max() <= tol * t.grad.abs().max() + 1e-6, \
                (B, h, N, M, d)


@pytest.mark.gpu
def test_sr_attention_raises_where_no_fused_kernel_takes_the_call():
    """Card-only: a head dimension neither fused backend takes (f64) raises
    instead of running the math path."""
    from seghiero_torch.ops import attention

    dev = _card()
    q = torch.randn((1, 1, 64, 64), device=dev, dtype=torch.float64)
    with pytest.raises(RuntimeError):
        attention.sr_attention(q, q, q)


@pytest.mark.gpu
def test_sr_attention_takes_the_pair_at_vit_l_global_attention():
    """Card-only: at ViT-L/16's global attention of a 1024² image, ``[1,
    16, 4097, 64]`` bf16 (65 key tiles, the last ragged) on the views of a
    fused ``qkv`` projection's tokens, ``sr_attention`` takes the
    hand-written pair #10 / #10b: one forward and one backward count, no
    SDPA call, and no kernel but the pair's (no copy of the views). Its
    output and gradients against the plain path, and its times beside SDPA
    flash's, are ``chip_smoke.py``'s ``kernels`` lines at this shape."""
    from torch.profiler import ProfilerActivity, profile

    from seghiero_torch.ops import attention

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(7)
    B, h, N, d = 1, 16, 4097, 64
    qkv = torch.randn((B, N, 3, h, d), generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = qkv.requires_grad_().permute(2, 0, 3, 1, 4)
    g = torch.randn((B, h, N, d), generator=gen, device=dev).to(torch.bfloat16)
    # a first call outside the profile: the kernel library's build
    torch.autograd.grad(attention.sr_attention(q, k, v), (q, k, v), g)
    torch.cuda.synchronize()
    before = (attention.launches, attention.bwd_launches, attention.sdpa_launches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(attention.sr_attention(q, k, v), (q, k, v), g)
        torch.cuda.synchronize()
    assert (attention.launches, attention.bwd_launches, attention.sdpa_launches) == (
        before[0] + 1, before[1] + 1, before[2])
    names = {e.name for e in prof.events() if e.device_type.name == "CUDA"}
    assert any("flash_fwd" in n for n in names) and any("flash_bwd" in n for n in names)
    assert all("seghiero" in n and ("flash_fwd" in n or "flash_bwd" in n) for n in names), \
        sorted(names)


# Swin's window attention: (B·nW, h, N, d, shifted) at Swin-L's stages 1 and
# 3 of two 640² images, and Swin-T's window 3 (N = 9, the mask's rows not a
# multiple of 16)
WINDOW_SHAPES = ((392, 6, 144, 32, True), (32, 24, 144, 32, False), (8, 3, 9, 32, True))


@pytest.mark.gpu
def test_window_attention_takes_the_memory_efficient_kernels_and_counts():
    """Card-only: ``window_attention`` in bf16 runs SDPA's memory-efficient
    kernels (``fmha_cutlassF`` forward, ``fmha_cutlassB`` backward), never
    the math path's softmax, with the bias broadcast over the windows
    (an unshifted block's ``[1, h, N, N]``) or whole (a shifted block's
    ``[B·nW, h, N, N]``); one forward and one backward count a call
    (``window_launches``, ``window_bwd_launches``). Output and the q, k, v
    and bias gradients match the plain path in f32 within 2e-2 of the
    largest (bf16 operands and bias)."""
    from torch.profiler import ProfilerActivity, profile

    from seghiero_torch.models import swin
    from seghiero_torch.ops import attention

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(6)
    for Bw, h, N, d, shifted in WINDOW_SHAPES:
        w = int(N ** 0.5)
        q, k, v = (torch.randn((Bw, h, N, d), generator=gen, device=dev).to(torch.bfloat16)
                   .requires_grad_() for _ in range(3))
        table = torch.randn(((2 * w - 1) ** 2, h), generator=gen, device=dev).requires_grad_()
        idx = swin.relative_position_index(w, dev).reshape(-1)

        def biased():
            bias = table[idx].view(N, N, h).permute(2, 0, 1)[None]
            if shifted:
                side = 2 * w
                mask = swin.shift_mask(side, side, w, w // 2, dev)
                bias = (bias + mask[:, None]).repeat(Bw // 4, 1, 1, 1)
            return bias

        g = torch.randn((Bw, h, N, d), generator=gen, device=dev).to(torch.bfloat16)
        torch.autograd.grad(attention.window_attention(q, k, v, biased()), (q, k, v, table), g)
        torch.cuda.synchronize()
        before = (attention.window_launches, attention.window_bwd_launches,
                  attention.launches, attention.sdpa_launches)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = attention.window_attention(q, k, v, biased())
            grads = torch.autograd.grad(out, (q, k, v, table), g)
            torch.cuda.synchronize()
        assert (attention.window_launches, attention.window_bwd_launches, attention.launches,
                attention.sdpa_launches) == (before[0] + 1, before[1] + 1, *before[2:])
        names = {e.name for e in prof.events() if e.device_type.name == "CUDA"}
        assert all(any(n.startswith(k) for n in names) for k in ("fmha_cutlassF",
                                                                  "fmha_cutlassB")), \
            sorted(names)[:20]
        assert not any("softmax" in n.lower() for n in names), sorted(names)[:20]
        q2, k2, v2 = (t.detach().float().requires_grad_() for t in (q, k, v))
        t2 = table.detach().clone().requires_grad_()
        bias2 = t2[idx].view(N, N, h).permute(2, 0, 1)[None]
        if shifted:
            bias2 = (bias2 + swin.shift_mask(2 * w, 2 * w, w, w // 2, dev)[:, None]).repeat(
                Bw // 4, 1, 1, 1)
        ref = attention.window_attention_plain(q2, k2, v2, bias2.to(torch.bfloat16))
        ref.backward(g.float())
        assert (out.float() - ref).abs().max() <= 2e-2 * ref.abs().max(), (Bw, h, N)
        for got, t in zip(grads, (q2, k2, v2, t2)):
            assert (got.float() - t.grad).abs().max() <= 2e-2 * t.grad.abs().max() + 1e-6, \
                (Bw, h, N)


@pytest.mark.gpu
def test_window_attention_raises_where_the_memory_efficient_kernel_does_not_take_the_call():
    """Card-only: f64, which the memory-efficient backend does not take,
    raises instead of running the math path."""
    from seghiero_torch.ops import attention

    dev = _card()
    q = torch.randn((4, 2, 144, 32), device=dev, dtype=torch.float64)
    with pytest.raises(RuntimeError):
        attention.window_attention(q, q, q, torch.zeros((1, 2, 144, 144), device=dev,
                                                        dtype=torch.float64))


def _triplet_replay_ms(classes, shape, hw, monkeypatch, spread=True):
    """(ms a replay, share of lanes past ``min_size``) of the range tree
    triplet's forward and backward on an f32 embedding ``shape`` [B, D, h, w]
    and the benchmark's seeded scenes of ``hw`` pixels, captured in a CUDA
    graph as the train step captures it; ``spread=False`` gathers the
    selections' own indices."""
    import json

    from hbench.core import scene
    from seghiero_torch.losses import tree_triplet

    dev = _card()
    tree = Hierarchy.from_class_config(
        json.loads((ROOT / "hbench" / "configs" / classes).read_text())["classes"])
    gen = scene.generator(GRAPH_SEED, dev, stream=1)
    lbl = scene.labels(gen, shape[0], hw, tree.n_fine)
    emb = torch.nn.functional.normalize(torch.randn(shape, generator=gen, device=dev), dim=1)
    emb.requires_grad_()
    shares = []
    spread_padding = tree_triplet._spread_padding

    def recorded(idx, lane_valid, n):
        shares.append((~lane_valid).float().mean())  # no sync: it is also captured
        return spread_padding(idx, lane_valid, n) if spread else idx

    monkeypatch.setattr(tree_triplet, "_spread_padding", recorded)

    def step():
        loss, _ = tree_triplet.tree_triplet_loss_range(emb.permute(0, 2, 3, 1), lbl, tree)
        return torch.autograd.grad(loss, emb)[0]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 20, float(shares[0])


@pytest.mark.gpu
def test_triplet_forward_and_backward_take_under_2_ms(monkeypatch):
    """Card-only: the tree triplet's forward and backward at the Swin-L
    cell's shape (150 classes, a [2, 256, 20, 20] embedding, 2 x 640^2
    scenes) take under 2 ms, its padded lanes on spread rows. Prints the
    time with the selections' own indices, and the share of lanes sent to
    spread rows there and at a 19-class Cityscapes shape (a [1, 256, 32, 32]
    embedding, one 1024^2 scene)."""
    ms, share = _triplet_replay_ms("swinl-2level.json", (2, 256, 20, 20), (640, 640),
                                   monkeypatch)
    piled_ms, _ = _triplet_replay_ms("swinl-2level.json", (2, 256, 20, 20), (640, 640),
                                     monkeypatch, spread=False)
    city_ms, city_share = _triplet_replay_ms("r50-2level.json", (1, 256, 32, 32),
                                             (1024, 1024), monkeypatch)
    print(f"triplet fwd+bwd, 150 classes [2, 256, 20, 20]: {ms:.4f} ms spread, "
          f"{piled_ms:.4f} ms piled, {100 * share:.2f} % of lanes spread; "
          f"19 classes [1, 256, 32, 32]: {city_ms:.4f} ms, {100 * city_share:.2f} % spread")
    assert ms < 2.0, (ms, piled_ms)


# -- the train step as one CUDA graph (``train/steps.py``) -------------------
# the benchmark's five training configurations at their CPU rehearsal's
# tiny size (64², ResNet-50 / MiT-B0 / Swin-T at window 3 / ViT-tiny at
# patch 16), with the harness's weights and scenes
GRAPH_CELLS = ("r50-2level.train-files", "r101-3level.train-769", "mitb5-3level.train-1024",
               "swinl-2level.train-640", "vitl16-3level.train-1024")
GRAPH_SEED = 3_000_000_019


def _graph_setup(cell, drop_path_rate=None, overrides=None):
    """(cfg, model, composite, optimizer, scheduler, batches, limits) of
    ``cell`` on the card; ``drop_path_rate`` overrides, and ``overrides``
    stand in the rehearsal's."""
    from hbench.core import harness, scene, spec, weights
    from seghiero_torch.config import SegHieroConfig
    from seghiero_torch.models.segmenter import build_model
    from seghiero_torch.train.optim import make_optimizer, make_schedule
    from seghiero_torch.train.steps import make_composite_loss

    dev = _card()
    bench = spec.Bench()
    ctx = harness.context(bench, cell, GRAPH_SEED, "cuda",
                          overrides=bench.rehearsal(cell) if overrides is None else overrides)
    port = ctx.port_config("train")
    # the weights of the configuration as it is (the reference runs no drop path)
    sd = weights.make(ctx.reference.build(port["model"], ctx.tree), ctx.seed, dev,
                      ctx.reference.RESIDUAL_LAST)
    if drop_path_rate is not None:
        port["model"].setdefault("backbone_options", {})["drop_path_rate"] = drop_path_rate
    cfg = SegHieroConfig.from_dict(port)
    with torch.device(dev):
        model = build_model(cfg)
    model = model.to(memory_format=torch.channels_last)
    model.load_state_dict(sd, strict=True)
    optimizer = make_optimizer(cfg.training, model)
    scheduler = make_schedule(cfg.training, 10**9, optimizer)
    b, hw = cfg.training.batch_size, tuple(cfg.transform.resize)
    images, fine = scene.scenes(scene.generator(GRAPH_SEED, dev, stream=1), 4 * b, hw,
                                ctx.tree.n_fine)
    batches = [{"image": images[i:i + b].contiguous(), "fine": fine[i:i + b].to(torch.int32)}
               for i in range(0, 4 * b, b)]
    return cfg, model, make_composite_loss(cfg), optimizer, scheduler, batches, \
        bench.limits(cell)


def _graph_run(cell, n_steps, eager, monkeypatch, after=None):
    """``n_steps`` train steps of ``cell`` from its fresh state: the losses,
    the parameters after, each step's launch counts, and whether a graph
    ran. ``eager``: never capture."""
    from seghiero_torch import ops
    from seghiero_torch.train import steps

    monkeypatch.setattr(steps, "EAGER_CALLS", 10**9 if eager else 2)
    cfg, model, composite, optimizer, scheduler, batches, _ = _graph_setup(cell)
    losses, counts = [], []
    for i in range(n_steps):
        before = ops.launch_counts()
        out = steps.train_step(model, composite, optimizer, cfg, batches[i % len(batches)], i,
                               0, scheduler)
        counts.append({k: n - before[k] for k, n in ops.launch_counts().items()})
        losses.append(out["loss"])
    torch.cuda.synchronize()
    graphed = steps._steps[optimizer].graph is not None
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return [float(x) for x in losses], params, counts, graphed


@pytest.mark.gpu
@pytest.mark.parametrize("cell", GRAPH_CELLS)
def test_replayed_steps_equal_eager_steps(cell, monkeypatch):
    """Card-only: ten steps whose third is captured and the rest replayed
    against ten eager steps from the same state: the same losses and
    parameters, bit for bit where two eager runs agree bit for bit, else
    within the cell's loss and ``change_gap`` limits; and every op's launch
    counter moves by one eager step's count on every replayed step. MiT's
    attention takes the hand-written pair on every step: SDPA's count
    stays at 0."""
    from hbench.reference import compare

    eager_a = _graph_run(cell, 10, True, monkeypatch)
    eager_b = _graph_run(cell, 10, True, monkeypatch)
    graph = _graph_run(cell, 10, False, monkeypatch)
    assert not eager_a[3] and graph[3]
    assert all(np.isfinite(graph[0]))
    # the launch counts: each replayed step counts what an eager step counts
    assert graph[2] == eager_a[2], (graph[2][-1], eager_a[2][-1])
    assert any(n > 0 for n in graph[2][-1].values())
    attn = "seghiero_torch.ops.attention."
    assert all(c[attn + "sdpa_launches"] == 0 for c in graph[2])
    if cell.startswith(("mitb5", "vitl16")):
        assert all(c[attn + "launches"] > 0 for c in graph[2])
    deterministic = eager_a[0] == eager_b[0] and all(
        torch.equal(eager_a[1][k], eager_b[1][k]) for k in eager_a[1])
    if deterministic:
        assert graph[0] == eager_a[0]
        assert all(torch.equal(graph[1][k], eager_a[1][k]) for k in eager_a[1])
        return
    *_, limits = _graph_setup(cell)
    loss_limit = next(v["limit"] for k, v in limits.items() if k.startswith("loss_gap"))
    gaps = [abs(a - b) / abs(b) for a, b in zip(graph[0], eager_a[0])]
    assert max(gaps) <= loss_limit, gaps
    init = _graph_setup(cell)[1].state_dict()
    norm = {k: float((eager_a[1][k] - init[k]).double().norm()) for k in eager_a[1]}
    mine = {k: float((graph[1][k] - init[k]).double().norm()) for k in graph[1]}
    gap = compare._median(compare.leaf_gaps(mine, norm).values())
    assert gap <= limits["change_gap"]["limit"], gap


@pytest.mark.gpu
@pytest.mark.parametrize("cell", GRAPH_CELLS)
def test_a_replayed_step_makes_no_host_sync(cell):
    """Card-only: once captured, a step runs under the sync debug mode's
    ``error`` without raising."""
    from seghiero_torch.train import steps

    cfg, model, composite, optimizer, scheduler, batches, _ = _graph_setup(cell)
    for i in range(3):
        steps.train_step(model, composite, optimizer, cfg, batches[i], i, 0, scheduler)
    torch.cuda.synchronize()
    assert steps._steps[optimizer].graph is not None
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = steps.train_step(model, composite, optimizer, cfg, batches[3], 3, 0, scheduler)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(out["loss"])


@pytest.mark.gpu
def test_a_replayed_swin_l_step_counts_24_window_attentions(monkeypatch):
    """Card-only: Swin-L (the cell's configuration at 128², 24 blocks, 12
    shifted) through two eager steps, the capture and two replays: every
    step counts 24 window-attention forwards and 24 backwards, and no
    other attention."""
    from seghiero_torch import ops
    from seghiero_torch.train import steps

    monkeypatch.setattr(steps, "EAGER_CALLS", 2)
    cfg, model, composite, optimizer, scheduler, batches, _ = _graph_setup(
        "swinl-2level.train-640", overrides={"modes": {"train": {
            "transform": {"resize": [128, 128]}, "training": {"batch_size": 2}}}})
    attn = "seghiero_torch.ops.attention."
    for i in range(5):
        before = ops.launch_counts()
        steps.train_step(model, composite, optimizer, cfg, batches[i % 4], i, 0, scheduler)
        moved = {k[len(attn):]: n - before[k] for k, n in ops.launch_counts().items()
                 if k.startswith(attn)}
        assert moved == {"launches": 0, "bwd_launches": 0, "sdpa_launches": 0,
                         "window_launches": 24, "window_bwd_launches": 24}, (i, moved)
    torch.cuda.synchronize()
    assert steps._steps[optimizer].graph is not None


@pytest.mark.gpu
def test_a_replayed_vit_l_step_counts_24_global_attentions(monkeypatch):
    """Card-only: ViT-L/16 (the cell's configuration at 128², 65 tokens,
    one image a batch, so UperNet's 1×1 pool normalizes one value a
    channel) through two eager steps, the capture and two replays: every
    step counts 24 forwards and 24 backwards of the hand-written pair, no
    SDPA call and no window attention, and its loss is finite."""
    from seghiero_torch import ops
    from seghiero_torch.train import steps

    monkeypatch.setattr(steps, "EAGER_CALLS", 2)
    cfg, model, composite, optimizer, scheduler, batches, _ = _graph_setup(
        "vitl16-3level.train-1024", overrides={"modes": {"train": {
            "transform": {"resize": [128, 128]}, "training": {"batch_size": 1}}}})
    attn = "seghiero_torch.ops.attention."
    for i in range(5):
        before = ops.launch_counts()
        out = steps.train_step(model, composite, optimizer, cfg, batches[i % 4], i, 0, scheduler)
        moved = {k[len(attn):]: n - before[k] for k, n in ops.launch_counts().items()
                 if k.startswith(attn)}
        assert moved == {"launches": 24, "bwd_launches": 24, "sdpa_launches": 0,
                         "window_launches": 0, "window_bwd_launches": 0}, (i, moved)
        assert torch.isfinite(out["loss"])
    torch.cuda.synchronize()
    assert steps._steps[optimizer].graph is not None


@pytest.mark.gpu
def test_a_batch_of_another_shape_runs_eagerly():
    """Card-only: after the capture, a batch of another size (48² crops)
    runs the eager step (no replay, the graph kept), and the captured shape
    replays again."""
    from seghiero_torch.train import steps

    cfg, model, composite, optimizer, scheduler, batches, _ = _graph_setup(
        "r101-3level.train-769")
    for i in range(3):
        steps.train_step(model, composite, optimizer, cfg, batches[i], i, 0, scheduler)
    runner = steps._steps[optimizer]
    real = runner.graph

    class Spy:
        n = 0

        def replay(self):
            Spy.n += 1
            real.replay()

    runner.graph = Spy()
    short = {k: v[:, :48, :48].contiguous() for k, v in batches[3].items()}
    out = steps.train_step(model, composite, optimizer, cfg, short, 3, 0, scheduler)
    assert Spy.n == 0 and steps._steps[optimizer] is runner
    assert torch.isfinite(out["loss"])
    out = steps.train_step(model, composite, optimizer, cfg, batches[0], 4, 0, scheduler)
    torch.cuda.synchronize()
    assert Spy.n == 1 and torch.isfinite(out["loss"])


@pytest.mark.gpu
def test_a_restore_after_the_capture_resumes_as_the_run_went_on(tmp_path):
    """Card-only: a checkpoint saved after the capture, restored into the
    same objects (which drops their graph), then four steps: the same
    losses and parameters as the four steps the run took after the save
    (bit for bit where two such runs agree, else within the cell's
    change limit)."""
    from seghiero_torch.train import steps
    from seghiero_torch.train.checkpoint import CheckpointManager

    cell = "mitb5-3level.train-1024"
    cfg, model, composite, optimizer, scheduler, batches, limits = _graph_setup(cell)
    ckpt = CheckpointManager(str(tmp_path), "graph")
    for i in range(4):
        steps.train_step(model, composite, optimizer, cfg, batches[i], i, 0, scheduler)
    ckpt.save(model, optimizer, scheduler, step=4, epoch=0, metrics={}, best_val_loss=1.0,
              config_raw={}, is_best=False)

    def four_more():
        losses = [steps.train_step(model, composite, optimizer, cfg, batches[i], 4 + i, 0,
                                   scheduler)["loss"] for i in range(4)]
        torch.cuda.synchronize()
        return ([float(x) for x in losses],
                {n: p.detach().clone() for n, p in model.named_parameters()})

    first = steps._steps[optimizer]
    went_on = four_more()
    ckpt.restore(4, model, optimizer, scheduler)
    assert optimizer not in steps._steps
    resumed = four_more()
    assert steps._steps[optimizer] is not first and steps._steps[optimizer].graph is not None
    if resumed[0] == went_on[0]:
        assert all(torch.equal(resumed[1][k], went_on[1][k]) for k in went_on[1])
        return
    gaps = [abs(a - b) / abs(b) for a, b in zip(resumed[0], went_on[0])]
    assert max(gaps) <= limits["loss_gap_median"]["limit"], gaps


@pytest.mark.gpu
def test_replays_draw_fresh_drop_path_masks():
    """Card-only: with MiT's drop path on and the learning rate 0 (a state
    that does not move), two replays of step 0 on one batch give two
    losses; with it off, the same loss."""
    from seghiero_torch.train import steps

    def two_replays(rate):
        cfg, model, composite, optimizer, _, batches, _ = _graph_setup(
            "mitb5-3level.train-1024", drop_path_rate=rate)
        for g in optimizer.param_groups:
            g["lr"] = 0.0
        losses = [steps.train_step(model, composite, optimizer, cfg, batches[0], 0)["loss"]
                  for _ in range(5)]
        assert steps._steps[optimizer].graph is not None
        return float(losses[3]), float(losses[4])

    a, b = two_replays(0.5)
    assert a != b
    a, b = two_replays(0.0)
    assert a == b


@pytest.mark.gpu
def test_fit_replays_the_step_under_the_profiler(tmp_path):
    """Card-only: ``Trainer.fit`` on a tiny 2-level config (kernels, flips,
    clip) with ``output.profile_dir``: the profiled steps 3–10 are the
    capture and its replays, traced; the epoch evaluates and saves."""
    import json

    from seghiero_torch.config import SegHieroConfig
    from seghiero_torch.train.trainer import Trainer

    _card()
    d = {
        "dataset": {"kind": "synthetic", "synthetic_size": 20},
        "classes": {"coarse_to_fine_map": [[0, 3], [4, 6], [7], [8]],
                    "coarse_names": {0: "a", 1: "b", 2: "c", 3: "d"},
                    "fine_names": {i: f"f{i}" for i in range(9)}},
        "model": {"depth": 18, "dtype": "bfloat16", "aspp_channels": 16, "c1_channels": 8,
                  "proj_dim": 8, "dilations": [1, 2, 3, 4], "depthwise_backend": "pallas"},
        "training": {"epochs": 1, "batch_size": 2, "lr": 0.01, "momentum": 0.9,
                     "weight_decay": 1e-4, "num_workers": 0, "log_every": 100,
                     "pallas_fused_loss": True, "grad_clip_norm": 1.0},
        "transform": {"resize": [64, 64], "hflip_prob": 0.5, "device_hflip": True},
        "output": {"checkpoint_dir": str(tmp_path / "ckpt"), "project_name": "graph",
                   "profile_dir": str(tmp_path / "prof")},
    }
    history = Trainer(SegHieroConfig.from_dict(d), device="cuda", verbose=False).fit()
    assert np.isfinite(history[-1]["train_loss"]) and np.isfinite(history[-1]["val_loss"])
    spans = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert spans["train.step"]["count"] == 8 and spans["train.replay"]["count"] == 8
    assert spans["train.forward"]["count"] == 1  # the capture's; a replay runs none
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


# -- the shipped configurations' paths --------------------------------------
ROOT = Path(__file__).resolve().parents[1]


def _shipped(config):
    """(config dict, tree, cfg) of ``configs/<config>``."""
    from hbench.reference.tree import from_classes
    from seghiero_torch.config import SegHieroConfig

    raw = yaml.safe_load((ROOT / "configs" / config).read_text())
    return raw, from_classes(raw["classes"]), SegHieroConfig.from_dict(raw)


def _model(cfg, sd, dev):
    from seghiero_torch.models.segmenter import build_model

    with torch.device(dev):
        model = build_model(cfg)
    model = model.to(memory_format=torch.channels_last)
    model.load_state_dict(sd, strict=True)
    return model


def _counted(fn):
    """``fn()`` and the launches it made, by ``ops.launch_counts``'s keys
    without their ``seghiero_torch.ops.`` prefix."""
    from seghiero_torch import ops

    before = ops.launch_counts()
    out = fn()
    after = ops.launch_counts()
    return out, {k.removeprefix("seghiero_torch.ops."): n - before[k] for k, n in after.items()}


# Each training config's kernel path against its library path on one batch
# with the same weights. The two run the same cuDNN backbone and differ in
# the head's two 3×3 depthwise convolutions and in the loss's kernels: f32
# sums in another order before a bf16 rounding. A logit moves by about one
# bf16 ulp (2^-8) where a rounding flips; the loss, a mean over the batch's
# pixels, by far less:
LOSS_RTOL = 1e-3
# each gradient entry carries such one-ulp differences back through up to
# 100 bf16 layers; uncorrelated perturbations of ≤ 0.4 % keep each
# parameter's gradient direction within 1 %:
GRAD_COS_MIN = 0.99
# and its norm within 2 % (5× that 0.4 %), so that a term whose gradient is
# off by a constant factor fails where a cosine alone would pass it:
GRAD_NORM_RTOL = 0.02
# config 4's fast RMI kernels against its parity kernels differ in the RMI
# term's Grams alone (bf16 views): the loss by at most the JAX package's
# fast-vs-parity tolerance of the term (tests/test_rmi_gram_pallas.py:75)
# times the term's share of the loss; its gradient, P·z with P and z
# rounded to bf16, reaches the parameters through the same bf16 layers, so
# it is held to GRAD_COS_MIN and GRAD_NORM_RTOL
RMI_FAST_VALUE_RTOL = 2e-2
# the triplet ramp is exactly 0 in f32 for a run's first steps: the
# comparison takes the loss mid-schedule, so the projection head's gradient
# is live on both paths
TRIPLET_LIVE_STEP = 40_000
# a train step's launches: the head's two separable convolutions' depthwise
# forward, input and weight gradient (the ASPP's dilated branches need a
# backward, so cuDNN's: no #9), and the loss's kernels
_DW = {"depthwise.launches": 2, "depthwise.dgrad_launches": 2, "depthwise.wgrad_launches": 2,
       "depthwise.dilated_launches": 0}
_FUSED = {"hiera2_fused.fwd_launches": 1, "hiera2_fused.bwd_launches": 1}
_RMI_PARITY = {f"rmi_gram.{k}{p}_launches": int(not p) for k in ("gram18", "residual", "grad")
               for p in ("", "_fast")}
_RMI_FAST = {k: 1 - n for k, n in _RMI_PARITY.items()}
_LAUNCHES_2 = {**_DW, **_FUSED, **dict.fromkeys(_RMI_PARITY, 0)}
# config: (the library path's loss knobs, the kernel path's launches a
# step), at the config's own size: the tolerances above are those of a loss
# over ~2 M pixels, and at 64² the stride-32 embedding is 2 × 2, where the
# device's scenes may hold no triplet (the projection head's gradient is
# then 0, and untested)
TRAIN_CONFIGS = {
    "example-train-hopper.yaml": ({"pallas_fused_loss": False}, _LAUNCHES_2),
    "example-train-150-hopper.yaml": ({"pallas_fused_loss": False}, _LAUNCHES_2),
    "example-train-3level-hopper.yaml": ({"rmi_backend": "xla"},
                                         {**_DW, **dict.fromkeys(_FUSED, 0), **_RMI_PARITY}),
    "example-train-r101-769-hopper.yaml": ({"rmi_backend": "xla"},
                                           {**_DW, **dict.fromkeys(_FUSED, 0), **_RMI_FAST}),
}


def _loss_and_grads(cfg, sd, batch, dev, monkeypatch):
    """(loss, the RMI term or None, each parameter's gradient, the
    launches) of one train-mode pass of ``cfg``'s path, no update."""
    from seghiero_torch.losses import fast as loss_fast
    from seghiero_torch.train.steps import forward_losses, make_composite_loss

    model, composite = _model(cfg, sd, dev).train(), make_composite_loss(cfg)
    rmi, real = [], loss_fast.rmi_lower_bound_cmajor

    def recording(*a, **kw):
        v = real(*a, **kw)
        rmi.append(float(v.detach()))
        return v

    def one_pass():
        loss = forward_losses(model, composite, cfg, batch, TRIPLET_LIVE_STEP)[0]
        loss.backward()
        return float(loss.detach())

    with monkeypatch.context() as mp:
        mp.setattr(loss_fast, "rmi_lower_bound_cmajor", recording)
        loss, counts = _counted(one_pass)
    grads = {n: p.grad for n, p in model.named_parameters()}
    return loss, rmi[0] if rmi else None, grads, counts


def _compare(a, b, rtol):
    """Failures of path ``a`` against ``b``: the loss beyond ``rtol``, a
    parameter's gradient below ``GRAD_COS_MIN`` or its norm beyond
    ``GRAD_NORM_RTOL``."""
    (loss_a, grads_a), (loss_b, grads_b) = a, b
    bad = []
    if abs(loss_a - loss_b) > rtol * abs(loss_b):
        bad.append(("loss", loss_a, loss_b, rtol))
    for n, ga in grads_a.items():
        ga, gb = ga.double().flatten(), grads_b[n].double().flatten()
        cos = float(torch.nn.functional.cosine_similarity(ga, gb, dim=0))
        dev_norm = abs(float(ga.norm() / gb.norm()) - 1.0)
        if not (cos >= GRAD_COS_MIN and dev_norm <= GRAD_NORM_RTOL):
            bad.append((n, cos, dev_norm))
    return bad


def _train_setup(config):
    """(cfg, the benchmark's seeded weights, one batch, the card) of a
    shipped training config at its own size."""
    from hbench.core import scene, weights
    from hbench.reference import model as reference

    dev = _card()
    raw, tree, cfg = _shipped(config)
    m, t = cfg.model, cfg.training
    assert (m.dtype, m.depthwise_backend) == ("bfloat16", "pallas")
    sd = weights.make(reference.build(raw["model"], tree), GRAPH_SEED, dev,
                      reference.RESIDUAL_LAST)
    images, fine = scene.scenes(scene.generator(GRAPH_SEED, dev, stream=1), t.batch_size,
                                tuple(cfg.transform.resize), tree.n_fine)
    return cfg, sd, {"image": images.contiguous(), "fine": fine.to(torch.int32)}, dev


# (config, path a, path b): each config's kernel path against its library
# path (``depthwise_backend: xla`` and the loss's library ops); config 4's
# parity kernels against the library, and its fast kernels against its
# parity kernels
COMPARED = (("example-train-hopper.yaml", "kernel", "library"),
            ("example-train-150-hopper.yaml", "kernel", "library"),
            ("example-train-3level-hopper.yaml", "kernel", "library"),
            ("example-train-r101-769-hopper.yaml", "parity", "library"),
            ("example-train-r101-769-hopper.yaml", "kernel", "parity"))


@pytest.mark.gpu
@pytest.mark.parametrize("config,a,b", COMPARED)
def test_a_training_configs_kernel_path_matches_its_library_path(config, a, b, monkeypatch):
    """Card-only: a shipped training config at its own size with the
    benchmark's seeded weights. On one batch, path ``a``'s loss and every
    parameter's gradient against path ``b``'s; each path's launches
    exact, every gradient of the kernel path finite and non-zero."""
    import dataclasses

    cfg, sd, batch, dev = _train_setup(config)
    library, launches = TRAIN_CONFIGS[config]
    m, t = cfg.model, cfg.training
    paths = {"kernel": cfg,
             "library": dataclasses.replace(
                 cfg, model=dataclasses.replace(m, depthwise_backend="xla"),
                 training=dataclasses.replace(t, **library)),
             "parity": dataclasses.replace(
                 cfg, training=dataclasses.replace(t, rmi_precision="parity"))}
    want = {"kernel": launches, "parity": {**_DW, **dict.fromkeys(_FUSED, 0), **_RMI_PARITY}}
    got, rmi = {}, {}
    for path in (a, b):
        loss, rmi[path], grads, counts = _loss_and_grads(paths[path], sd, batch, dev,
                                                         monkeypatch)
        if path in want:
            assert {k: counts[k] for k in want[path]} == want[path], (path, counts)
        if path == "kernel":
            bad = [n for n, g in grads.items() if g is None or not bool(torch.isfinite(g).all())
                   or not bool(g.abs().max() > 0)]
            assert not bad, bad
        got[path] = (loss, grads)
    rtol = LOSS_RTOL
    if b == "parity":  # the RMI term's share of the loss on the parity path
        rtol = RMI_FAST_VALUE_RTOL * abs(t.fine_weight * rmi[b] / got[b][0])
    bad = _compare(got[a], got[b], rtol)
    assert not bad, (a, b, bad)


@pytest.mark.gpu
@pytest.mark.parametrize("config", TRAIN_CONFIGS)
def test_a_training_configs_steps_launch_its_kernels(config):
    """Card-only: four ``train_step`` calls of a shipped training config
    at its own size (two eager, the capture, a replay), each with exactly
    the config's launches a step and a finite loss."""
    from seghiero_torch.train import steps
    from seghiero_torch.train.optim import make_optimizer
    from seghiero_torch.train.steps import make_composite_loss

    cfg, sd, batch, dev = _train_setup(config)
    launches = TRAIN_CONFIGS[config][1]
    model = _model(cfg, sd, dev)
    optimizer = make_optimizer(cfg.training, model)
    composite = make_composite_loss(cfg)
    for i in range(4):
        out, counts = _counted(lambda: steps.train_step(model, composite, optimizer, cfg,
                                                        batch, i))
        assert {k: counts[k] for k in launches} == launches, (i, counts)
        assert bool(torch.isfinite(out["loss"]))
    assert steps._steps[optimizer].graph is not None


# Config 5's inference (ResNet-101, 3 levels, both kernels) at its own
# size, 1024²: the infer CLI on PNGs of two sizes (1024², whose masks take
# the decode #3, and 960×1280, whose masks take the library decode) in
# batches of 4; a sliding window (6 windows of 1024² over 1536×2048) and
# TTA (scales 0.75 / 1 / 1.25 with flip: 6 forwards). The kernel path
# against the library-op predictor on the same batches: the depthwise
# kernels sum in another f32 order before a bf16 rounding and the decode
# multiplies in another order, which flips an argmax only where two logits
# nearly tie:
AGREE_MIN = 0.995
CLI_IMAGES = {(1024, 1024): 8, (960, 1280): 3}  # (H, W): count
SLIDING = {"hw": (1536, 2048), "window": (1024, 1024), "stride": (512, 512)}
TTA_SCALES = (0.75, 1.0, 1.25)
INFER_RUNS = ("cli", "sliding", "tta")


def _levels_agree(a, b):
    """Per level, the smallest share over the images of pixels where the
    two masks agree."""
    return {lvl: min(float((a[lvl][j] == b[lvl][j]).mean()) for j in range(len(a[lvl])))
            for lvl in a}


@pytest.mark.gpu
@pytest.mark.parametrize("run", INFER_RUNS)
def test_config_5_inference_matches_predict_array_and_the_library_path(run, tmp_path):
    """Card-only: config 5 at 1024² with the benchmark's seeded, calibrated
    weights saved as a port checkpoint directory. ``cli``: the infer CLI
    (in process, the config's best checkpoint) writes every level's masks,
    equal to ``predict_array``'s on the same batches; ``sliding``, ``tta``:
    the predictor's runs. Each run's masks agree with the library-op
    predictor's on ≥ 99.5 % of each level's pixels, its logits are finite,
    and it launches 2 of #1 and 3 of #9 a forward, and #3 once a batch of
    1024² masks (no other)."""
    from PIL import Image

    from hbench.core import predictlib
    from hbench.reference import model as reference
    from seghiero_torch.infer.__main__ import main as infer_main
    from seghiero_torch.infer.predictor import Predictor, preprocess_image
    from seghiero_torch.models.segmenter import build_model
    from seghiero_torch.train.checkpoint import CheckpointManager

    dev = _card()
    raw, tree, cfg = _shipped("example-serving-3level-r101-hopper.yaml")
    m = cfg.model
    size = tuple(cfg.transform.resize)
    assert (m.depth, m.dtype, m.depthwise_backend, m.argmax_backend, tree.total, size) == (
        101, "bfloat16", "pallas", "pallas", 15, (1024, 1024))
    raw["output"] = {"checkpoint_dir": str(tmp_path / "ckpt"), "project_name": "infer5"}
    sd = predictlib.seeded_weights(reference, raw, tree, GRAPH_SEED, dev)
    model = build_model(cfg)
    model.load_state_dict(sd, strict=True)
    CheckpointManager(raw["output"]["checkpoint_dir"], "infer5").save(
        model, torch.optim.SGD(model.parameters(), lr=0.0), None, step=1, epoch=1, metrics={},
        best_val_loss=0.0, config_raw=raw, is_best=True)
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    cfg = type(cfg).from_dict(raw)
    predictor = Predictor.from_checkpoint(cfg, None, device=dev)  # as the CLI finds it
    library = predictlib.predictor(
        dict(raw, model=dict(raw["model"], depthwise_backend="xla", argmax_backend="xla")),
        sd, dev)
    rng = np.random.default_rng(GRAPH_SEED)
    per_forward = {"depthwise.launches": 2, "depthwise.dilated_launches": 3}

    if run == "cli":
        images, out_dir = tmp_path / "images", tmp_path / "out"
        images.mkdir()
        for (H, W), n in CLI_IMAGES.items():
            for i in range(n):
                Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(
                    images / f"img{W}x{H}_{i}.png")
        rc, counts = _counted(lambda: infer_main([
            "--config", str(cfg_path), "--image-dir", str(images), "--batch-size", "4",
            "--output-dir", str(out_dir)]))
        assert rc == 0
        n_batches = sum(-(-n // 4) for n in CLI_IMAGES.values())
        want = {k: v * n_batches for k, v in per_forward.items()}
        want["upsample_argmax.launches"] = -(-CLI_IMAGES[size] // 4)
        names = sorted(p.stem for p in images.iterdir())
        assert {p.name for p in out_dir.iterdir()} == {
            f"{n}_{lvl}{sfx}.png" for n in names for lvl in tree.levels for sfx in ("", "_color")}
        agree = []
        for (H, W), n in CLI_IMAGES.items():
            for start in range(0, n, 4):
                chunk = [f"img{W}x{H}_{i}" for i in range(start, min(start + 4, n))]
                batch = np.stack([preprocess_image(str(images / f"{b}.png"), size)[0]
                                  for b in chunk])
                direct = predictor.predict_array(batch, out_hw=(H, W))
                for j, b in enumerate(chunk):
                    for lvl in tree.levels:
                        written = np.asarray(Image.open(out_dir / f"{b}_{lvl}.png"))
                        assert np.array_equal(written, direct[lvl][j]), (b, lvl)
                agree.append(_levels_agree(direct, library.predict_array(batch, out_hw=(H, W))))
                logits = predictor.logits(batch)
        agree = {lvl: min(a[lvl] for a in agree) for lvl in tree.levels}
    else:
        if run == "sliding":
            img = rng.integers(0, 256, (1, *SLIDING["hw"], 3), dtype=np.uint8)

            def go(p):
                return p.predict_sliding(img, SLIDING["window"], SLIDING["stride"])
        else:
            img = rng.integers(0, 256, (1, *size, 3), dtype=np.uint8)

            def go(p):
                return p.predict_tta(img, scales=TTA_SCALES, flip=True)
        masks, counts = _counted(lambda: go(predictor))
        want = {k: 6 * v for k, v in per_forward.items()}
        want["upsample_argmax.launches"] = 0
        agree = _levels_agree(masks, go(library))
        logits = predictor.logits(img[:, :size[0], :size[1]])
    assert {k: counts[k] for k in want} == want, counts
    assert min(agree.values()) >= AGREE_MIN, agree
    assert bool(torch.isfinite(logits).all())
