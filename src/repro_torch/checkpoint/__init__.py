"""Checkpointing: atomic, keep-k, full-state restore."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
