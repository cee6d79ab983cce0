"""PyTorch/CUDA port of the distributed Layered-LSH index.

A second package beside the JAX reference ``repro``, with the same module
tree: ``core`` (config, jax-compatible PRNG, hashing, offsets, the index),
``kernels`` (the hand-written CUDA bucket-search kernels, their plain
PyTorch versions and the layout dispatch), ``serving`` (the micro-batching
service) and ``convert`` (carries the reference's sampled parameters
across).  It imports torch and numpy only.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
