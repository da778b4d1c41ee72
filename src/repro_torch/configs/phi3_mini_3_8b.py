"""phi3-mini-3.8b [dense]: RoPE SwiGLU, MHA (kv=32) [arXiv:2404.14219]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    """The published configuration (see the module docstring)."""
    return ModelConfig(
        name="phi3-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32064,
        source="arXiv:2404.14219; unverified",
    )
