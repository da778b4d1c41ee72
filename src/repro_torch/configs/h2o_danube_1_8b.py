"""h2o-danube-1.8b [dense]: llama+mistral mix with sliding-window attention
[arXiv:2401.16818].  The 4096-token window bounds the KV cache, so this arch
runs the long_500k cell."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    """The published configuration (see the module docstring)."""
    return ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6912,
        vocab_size=32000,
        window=4096,
        source="arXiv:2401.16818; hf",
    )
