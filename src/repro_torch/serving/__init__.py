"""Serving of the port: sampling and the static batched engine."""
