"""Checkpointing of the port (``repro/checkpoint``)."""
from repro_torch.checkpoint.checkpoint import (
    CheckpointConfig,
    CheckpointManager,
)

__all__ = ["CheckpointConfig", "CheckpointManager"]
