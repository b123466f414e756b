"""Plain PyTorch references of what the benchmark's cells serve.

Imports neither JAX, nor the JAX package, nor anything of ``repro_torch``.
"""
