"""whisper-medium [audio]: enc-dec, conv frontend stubbed to precomputed
frame embeddings per assignment [arXiv:2212.04356].  24 encoder + 24 decoder
layers, sinusoidal positions, MHA (kv=16)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    """The published configuration (see the module docstring)."""
    return ModelConfig(
        name="whisper-medium",
        family="encdec",
        n_layers=24,
        encoder_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab_size=51865,
        pos_embed="sinusoidal",
        frontend="audio",
        tie_embeddings=True,
        source="arXiv:2212.04356; unverified",
    )
