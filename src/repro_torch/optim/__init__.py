"""Optimizer of the port (``repro/optim``): AdamW with global-norm clipping
and the cosine schedule, and the int8 gradient compression."""
from repro_torch.optim.optimizer import (
    OptimizerConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)
from repro_torch.optim import compression

__all__ = ["OptimizerConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "compression"]
