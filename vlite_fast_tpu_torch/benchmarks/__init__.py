"""Microbenchmarks of the port (the JAX package's benchmarks/, on the card)."""
