"""The model stack (every family: dense, MoE, SSM, hybrid, VLM and
enc-dec; serving and training), the port of the JAX package's
``repro.models``."""
from repro_torch.models.config import (ModelConfig, attention_flops,
                                       flops_per_token)
from repro_torch.models.transformer import Model, build

__all__ = ["ModelConfig", "Model", "build", "flops_per_token",
           "attention_flops"]
