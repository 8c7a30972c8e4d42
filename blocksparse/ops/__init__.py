"""Compute paths: the XLA engines and their dispatch."""
