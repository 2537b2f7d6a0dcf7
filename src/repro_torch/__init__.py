"""PyTorch/CUDA port of the LRD system (``repro``), run on an NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing of
it.  Its layout mirrors ``repro`` module for module, and it keeps the JAX
param tree (nested dicts, layers stacked on a leading ``L`` axis, factors
``u (C, r)`` / ``v (r, S)``) so parity tests compare leaf by leaf.
"""
