"""The deterministic synthetic data pipeline, the port of the JAX
package's ``repro.data`` (``make_batch_specs``: the dry-run's
storage-free stand-ins of a batch)."""
from repro_torch.data.pipeline import (DataConfig, SyntheticLMData,
                                       make_batch_specs)

__all__ = ["DataConfig", "SyntheticLMData", "make_batch_specs"]
