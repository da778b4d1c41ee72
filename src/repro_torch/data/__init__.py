"""The deterministic synthetic data pipeline, the port of the JAX
package's ``repro.data`` (``make_batch_specs``, the dry-run's shape
stand-ins, is not ported)."""
from repro_torch.data.pipeline import DataConfig, SyntheticLMData

__all__ = ["DataConfig", "SyntheticLMData"]
