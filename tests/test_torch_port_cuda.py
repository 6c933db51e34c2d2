"""Card-only: the port's CUDA kernels against their plain PyTorch versions.

Skips with a reason where no CUDA card is visible (the kernels have no CPU
mode). This file imports nothing of JAX, so it also runs on a machine
without it; there, skip the JAX-pinning conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_cuda.py
"""

import pytest
import torch

from seghiero_torch.ops import depthwise as port_dw
from seghiero_torch.ops import upsample_argmax as port_ua


@pytest.mark.gpu
def test_cuda_kernels_equal_plain_versions():
    """Card-only: each CUDA kernel against its plain version, bit for bit,
    at odd sizes (vector-width fallbacks, partial blocks) and one serving
    shape; a non-contiguous input raises instead of being copied."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((2, 13, 11, 3), (1, 9, 20, 130), (3, 17, 5, 6), (2, 128, 128, 560)):
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            k9 = torch.randn((9, shape[-1]), generator=gen, device=dev).to(dtype)
            before = port_dw.launches
            got = port_dw.depthwise3x3(x, k9)
            assert port_dw.launches == before + 1
            assert torch.equal(got, port_dw.depthwise3x3_plain(x, k9)), (dtype, shape)
        for shape, slices in (((2, 13, 6, 10), [(0, 9), (9, 13)]),
                              ((1, 15, 7, 9), [(0, 9), (9, 13), (13, 15)]),
                              ((8, 13, 128, 128), [(0, 9), (9, 13)])):
            lo = torch.randn(shape, generator=gen, device=dev).to(dtype)
            lo[:, 4] = lo[:, 2]
            for g, w in zip(port_ua.upsample_argmax(lo, slices),
                            port_ua.upsample_argmax_plain(lo, slices)):
                assert torch.equal(g, w), (dtype, shape)
    x = torch.randn((1, 8, 8, 4), device=dev)
    with pytest.raises(ValueError, match="refusing to copy"):
        port_dw.depthwise3x3(x.transpose(1, 2), torch.randn((9, 4), device=dev))
    with pytest.raises(ValueError, match="refusing to copy"):
        port_ua.upsample_argmax(torch.randn((1, 3, 4, 4), device=dev).transpose(2, 3), [(0, 3)])
