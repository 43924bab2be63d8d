"""Data of the port: the synthetic Markov LM and its batches on a device."""
