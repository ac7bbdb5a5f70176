"""Checkpointing of the port (``repro/checkpoint``)."""
from repro_torch.checkpoint.checkpoint import (
    CheckpointConfig,
    CheckpointManager,
    Layout,
)

__all__ = ["CheckpointConfig", "CheckpointManager", "Layout"]
