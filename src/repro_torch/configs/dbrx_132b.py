"""dbrx-132b [moe]: 16 experts top-4, fine-grained [hf:databricks/dbrx-base]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    """The published configuration (see the module docstring)."""
    return ModelConfig(
        name="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab_size=100352,
        n_experts=16,
        experts_per_token=4,
        source="hf:databricks/dbrx-base; unverified",
    )
