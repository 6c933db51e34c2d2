"""Input normalization on the device (counterpart of
``seghiero_tpu/data/pipeline.py:normalize_images``): images travel as
uint8 and are normalized where they are consumed."""

from __future__ import annotations

import torch


def normalize_images(
    images_u8: torch.Tensor,
    mean=(0.485, 0.456, 0.406),
    std=(0.229, 0.224, 0.225),
) -> torch.Tensor:
    """uint8 NHWC → f32 ``(x − 255·mean) / (255·std)`` on the tensor's
    device, matching torchvision ToTensor+Normalize."""
    dev = images_u8.device
    mean = torch.tensor(mean, dtype=torch.float32, device=dev) * 255.0
    std = torch.tensor(std, dtype=torch.float32, device=dev) * 255.0
    return (images_u8.to(torch.float32) - mean) / std
