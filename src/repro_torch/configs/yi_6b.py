"""yi-6b [dense]: llama-arch GQA kv=4 [arXiv:2403.04652]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    """The published configuration (see the module docstring)."""
    return ModelConfig(
        name="yi-6b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        source="arXiv:2403.04652; hf",
    )
