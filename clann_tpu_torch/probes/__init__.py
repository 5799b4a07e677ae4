"""Measurement entry points of the port (each needs a CUDA device)."""
