"""hymba-1.5b [hybrid]: parallel attention + mamba heads per layer
[arXiv:2411.13676].  SWA on the attention path (window 1024) + SSM state 16;
both state streams are bounded, so this arch runs long_500k."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    """The published configuration (see the module docstring)."""
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        d_head=64,
        d_ff=5504,
        vocab_size=32001,
        window=1024,
        ssm_state=16,
        ssm_headdim=64,
        tie_embeddings=True,
        source="arXiv:2411.13676; hf",
    )
