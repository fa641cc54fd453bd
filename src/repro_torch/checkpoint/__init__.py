"""Checkpointing: atomic, keep-k, full-state restore."""
from repro_torch.checkpoint import manager, reshard
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.reshard import merge_opt_state, reshard_clients, to_mesh

__all__ = ["manager", "reshard", "CheckpointManager", "merge_opt_state", "reshard_clients", "to_mesh"]
