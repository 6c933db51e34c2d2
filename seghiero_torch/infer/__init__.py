from seghiero_torch.infer.predictor import Predictor, preprocess_image, resolve_device
from seghiero_torch.infer.viz import (
    create_colormap,
    draw_class_indices,
    mask_to_color_image,
    save_mask,
)

__all__ = [
    "Predictor",
    "create_colormap",
    "draw_class_indices",
    "mask_to_color_image",
    "preprocess_image",
    "resolve_device",
    "save_mask",
]
