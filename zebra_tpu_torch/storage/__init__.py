"""Persistence of the torch port (the JAX package's formats)."""
