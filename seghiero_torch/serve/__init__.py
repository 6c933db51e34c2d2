from seghiero_torch.serve.server import MicroBatcher, ServingModel, make_server

__all__ = ["MicroBatcher", "ServingModel", "make_server"]
