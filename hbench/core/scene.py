"""Seeded street-scene stand-ins: label maps of a few rectangles and discs
of random fine classes over class 0, about 2 % of pixels ignored (255),
and images of a per-class colour plus Gaussian noise (σ 12), as uint8.
Made with one ``torch.Generator`` on the device that holds it, in a few
large calls; the same seed and device give the same arrays."""

from __future__ import annotations

import torch

IGNORE = 255


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2**63 - 1))
    return g


def labels(gen: torch.Generator, n: int, hw, n_classes: int, shapes: int = 8,
           ignore: float = 0.02) -> torch.Tensor:
    """``[n, H, W]`` int64 fine ids (255 = ignore)."""
    dev = gen.device
    H, W = hw
    yy = torch.arange(H, device=dev, dtype=torch.float32)[None, :, None]
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, None, :]
    p = torch.rand(n, shapes, 5, generator=gen, device=dev)
    cls = torch.randint(0, n_classes, (n, shapes), generator=gen, device=dev)
    fine = torch.zeros(n, H, W, dtype=torch.int64, device=dev)
    for s in range(shapes):
        y0, x0 = p[:, s, 1] * H * 0.8, p[:, s, 2] * W * 0.8
        hh, ww = (0.1 + 0.5 * p[:, s, 3]) * H, (0.1 + 0.5 * p[:, s, 4]) * W
        y0, x0, hh, ww = (v[:, None, None] for v in (y0, x0, hh, ww))
        rect = (yy >= y0) & (yy < y0 + hh) & (xx >= x0) & (xx < x0 + ww)
        r = torch.minimum(hh, ww) / 2
        disc = (yy - y0 - hh / 2) ** 2 + (xx - x0 - ww / 2) ** 2 <= r * r
        inside = torch.where((p[:, s, 0] < 0.5)[:, None, None], rect, disc)
        fine = torch.where(inside, cls[:, s, None, None], fine)
    drop = torch.rand(n, H, W, generator=gen, device=dev) < ignore
    return torch.where(drop, IGNORE, fine)


def images(gen: torch.Generator, fine: torch.Tensor, n_classes: int) -> torch.Tensor:
    """``[n, H, W, 3]`` uint8 images of the label maps ``fine``."""
    dev = gen.device
    palette = torch.randint(40, 215, (n_classes, 3), generator=gen, device=dev).float()
    base = palette[torch.where(fine == IGNORE, 0, fine)]
    noise = torch.randn(base.shape, generator=gen, device=dev) * 12.0
    return (base + noise).round().clamp(0, 255).to(torch.uint8)


def scenes(gen: torch.Generator, n: int, hw, n_classes: int):
    """(images uint8 ``[n, H, W, 3]``, fine labels int64 ``[n, H, W]``)."""
    fine = labels(gen, n, hw, n_classes)
    return images(gen, fine, n_classes), fine
