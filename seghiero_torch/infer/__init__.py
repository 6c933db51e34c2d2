from seghiero_torch.infer.predictor import Predictor, resolve_device

__all__ = ["Predictor", "resolve_device"]
