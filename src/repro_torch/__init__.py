"""PyTorch/CUDA port of the AsyncFlow reproduction.

Mirrors ``src/repro/`` (the JAX reference) module for module. It imports
``torch`` and never ``jax`` or anything of ``repro``; what it needs from
the reference's framework-free modules it keeps as its own copy.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
