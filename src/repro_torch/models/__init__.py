"""The model stack's serving path (dense, SSM and hybrid families), the
port of the JAX package's ``repro.models``."""
from repro_torch.models.config import (ModelConfig, attention_flops,
                                       flops_per_token)
from repro_torch.models.transformer import Model, build

__all__ = ["ModelConfig", "Model", "build", "flops_per_token",
           "attention_flops"]
