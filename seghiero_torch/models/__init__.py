from seghiero_torch.models.segmenter import HieroSegmenter, build_model

__all__ = ["HieroSegmenter", "build_model"]
