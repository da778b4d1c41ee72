"""Fault-tolerant checkpointing, the port of the JAX package's
``repro.checkpoint``."""
from repro_torch.checkpoint.store import (CheckpointManager, latest_step,
                                          load_checkpoint, save_checkpoint)

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint",
           "latest_step"]
