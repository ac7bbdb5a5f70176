"""Models of the port (dense GQA, the ("global",) pattern)."""
from repro_torch.models.zoo import Model, build_model, init_params

__all__ = ["Model", "build_model", "init_params"]
