"""The optimizer: AdamW with float32 master weights and the warmup-cosine
schedule, the port of the JAX package's ``repro.optim``."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                    adamw_update_, schedule)
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "adamw_update_",
           "schedule", "warmup_cosine"]
