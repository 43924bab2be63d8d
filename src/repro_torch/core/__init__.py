"""MoE layer of the port: gating, grouped dispatch, the layer itself."""
