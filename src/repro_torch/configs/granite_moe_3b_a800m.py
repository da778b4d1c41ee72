"""granite-moe-3b-a800m [moe]: 40 experts top-8, fine-grained
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    """The published configuration (see the module docstring)."""
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        n_experts=40,
        experts_per_token=8,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
    )
