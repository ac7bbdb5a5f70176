"""Models of the port: the reference zoo's ten architectures."""
from repro_torch.models.zoo import Model, build_model, demo_batch, init_params

__all__ = ["Model", "build_model", "demo_batch", "init_params"]
