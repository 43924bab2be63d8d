"""Checkpoints in the JAX package's format, written and read by the port."""
