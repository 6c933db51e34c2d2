"""Mask export and visualization (the port's own copy of
``seghiero_tpu/infer/viz.py``): grayscale mask PNGs, solid colormap
renderings, and class-index labels drawn at region centroids. The same
mask gives the same PNG bytes in both packages.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from PIL import Image, ImageDraw, ImageFont

# 19-color cycling palette, the reference's choices (its infer.py:90-110),
# so exported colors are identical for existing users
BASE_COLORS: Tuple[Tuple[int, int, int], ...] = (
    (128, 64, 128),
    (244, 35, 232),
    (70, 70, 70),
    (102, 102, 156),
    (190, 153, 153),
    (153, 153, 153),
    (250, 170, 30),
    (220, 220, 0),
    (107, 142, 35),
    (152, 251, 152),
    (70, 130, 180),
    (220, 20, 60),
    (255, 0, 0),
    (0, 0, 142),
    (0, 0, 70),
    (0, 60, 100),
    (0, 80, 100),
    (0, 0, 230),
    (119, 11, 32),
)


def create_colormap(n: int) -> List[Tuple[int, int, int]]:
    return [BASE_COLORS[i % len(BASE_COLORS)] for i in range(n)]


def save_mask(mask: np.ndarray, path: str) -> None:
    Image.fromarray(mask.astype(np.uint8)).save(path)


def mask_to_color_image(mask: np.ndarray, colormap) -> Image.Image:
    """One palette take per pixel; negative ids render black."""
    palette = np.asarray(colormap, dtype=np.uint8)
    safe = np.clip(mask, 0, len(palette) - 1)
    rgb = palette[safe]
    rgb[mask < 0] = 0
    return Image.fromarray(rgb, "RGB")


def draw_class_indices(
    mask: np.ndarray, base_img: Image.Image, font_path: Optional[str] = None
) -> Image.Image:
    """Class index at each region centroid, white text with a black
    outline."""
    H, W = mask.shape
    result = base_img.copy()
    draw = ImageDraw.Draw(result)
    try:
        font = ImageFont.truetype(font_path or "arial.ttf", size=max(12, W // 100))
    except (OSError, ImportError):  # no such font, or no FreeType: PIL's built-in one
        font = ImageFont.load_default()

    for class_id in np.unique(mask):
        if class_id < 0:
            continue
        ys, xs = np.nonzero(mask == class_id)
        if xs.size == 0:
            continue
        cx, cy = int(xs.mean()), int(ys.mean())
        text = str(int(class_id))
        bbox = draw.textbbox((0, 0), text, font=font)
        pos = (cx - (bbox[2] - bbox[0]) // 2, cy - (bbox[3] - bbox[1]) // 2)
        for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            draw.text((pos[0] + dx, pos[1] + dy), text, font=font, fill="black")
        draw.text(pos, text, fill="white", font=font)
    return result
