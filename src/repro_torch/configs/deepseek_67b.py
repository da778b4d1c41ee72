"""deepseek-67b [dense]: llama-arch GQA [arXiv:2401.02954]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    """The published configuration (see the module docstring)."""
    return ModelConfig(
        name="deepseek-67b",
        family="dense",
        n_layers=95,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab_size=102400,
        source="arXiv:2401.02954; hf",
    )
