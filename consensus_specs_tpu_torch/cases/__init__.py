"""Dual-mode test cases the generators turn into vectors (the port's
copies of the JAX package's ``tests/spec`` modules, one per handler)."""
