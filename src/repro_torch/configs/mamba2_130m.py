"""mamba2-130m [ssm]: SSD (state-space duality), attention-free
[arXiv:2405.21060].  Recurrent state only -> runs long_500k."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    """The published configuration (see the module docstring)."""
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_headdim=64,
        tie_embeddings=True,
        source="arXiv:2405.21060; unverified",
    )
