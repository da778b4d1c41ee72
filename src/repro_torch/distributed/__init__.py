"""Distribution of the port, the counterpart of the JAX package's
``repro.distributed``: the sharding rules over a ``DeviceMesh``
(``sharding``), int8 gradient compression across pods (``compression``)
and elastic re-meshing (``elastic``).  ``steps`` imports the model
layer; import it directly."""
from repro_torch.distributed import compression, elastic, sharding

__all__ = ["sharding", "compression", "elastic"]
