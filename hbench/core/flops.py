"""Model FLOPs per image, counted by ``torch.utils.flop_counter`` over the
plain reference model on the meta device (convolutions and matrix
products; a multiply-add is 2 FLOPs). The count is of the model's work,
whatever kernels the program runs: forward for inference, forward and
backward (no gradient for the input image) for training.

PyTorch's own formula for a convolution's backward leaves out its groups
(a depthwise 3x3's backward reads 65 times its forward at 64 channels);
here each gradient a backward computes costs what its forward does."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count


def _conv_backward(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation,
                   transposed, _output_padding, _groups, output_mask, out_shape=None) -> int:
    """The input and weight gradients each cost the forward's FLOPs."""
    fwd = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def per_image(model: torch.nn.Module, hw, train: bool) -> float:
    """FLOPs of one image at ``hw`` through ``model`` (on the meta device),
    counted on a batch of two (train-mode BatchNorm of the pooled branch
    needs more than one value a channel)."""
    x = torch.zeros(2, 3, *hw, device="meta")
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward})
    with counter:
        if train:
            out = model(x, with_train_heads=True)
            sum(v.sum() for v in out.values()).backward()
        else:
            with torch.no_grad():
                model(x, with_train_heads=False)
    if train:
        model.zero_grad(set_to_none=True)
    return counter.get_total_flops() / 2.0
