"""The train and serve step builders and the elastic accumulation plan on
one device, the port of the JAX package's ``repro.distributed`` (its
mesh, sharding rules, gradient compression and ``elastic.place`` come
with the multi-card slice).  ``steps`` imports the model layer; import
it directly."""
from repro_torch.distributed import elastic

__all__ = ["elastic"]
