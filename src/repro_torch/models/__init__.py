"""Layers of the port: norms, MLP, RoPE, attention, blocks, model."""
