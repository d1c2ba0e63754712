"""Interchange with the JAX package's weight trees."""
