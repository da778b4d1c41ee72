"""The chain compiler of the port (``core/transform_chain.py``).

Unlike the JAX package's ``repro.core``, this package ``__init__`` imports
nothing: import ``repro_torch.core.transform_chain`` for ``TransformChain``.
"""
