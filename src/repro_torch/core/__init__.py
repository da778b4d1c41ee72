"""The core modules of the port: the chain compiler
(``core/transform_chain.py``), the eager primitives and composite
builders (``core/transform_engine.py``), the M1 emulator
(``core/morphosys``) and the paper's table arithmetic
(``core/analysis.py``).

Unlike the JAX package's ``repro.core``, this package ``__init__`` imports
nothing: import ``repro_torch.core.transform_chain`` for ``TransformChain``.
"""
