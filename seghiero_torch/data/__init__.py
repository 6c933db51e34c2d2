from seghiero_torch.data.pipeline import BatchLoader, normalize_images
from seghiero_torch.data.transforms import resize_mask_nearest

__all__ = ["BatchLoader", "normalize_images", "resize_mask_nearest"]
