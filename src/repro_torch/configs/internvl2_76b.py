"""internvl2-76b [vlm]: InternViT + InternLM2 backbone [arXiv:2404.16821].

Backbone-only per assignment: the vision frontend is a stub supplying
precomputed patch embeddings for the first 256 positions."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    """The published configuration (see the module docstring)."""
    return ModelConfig(
        name="internvl2-76b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        frontend="vision",
        remat="full",
        n_frontend_tokens=256,
        source="arXiv:2404.16821; unverified",
    )
