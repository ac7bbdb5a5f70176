"""Data pipeline of the port (``repro/data``)."""
from repro_torch.data.pipeline import DataConfig, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline"]
