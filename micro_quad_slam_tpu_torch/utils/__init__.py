"""Utilities of the PyTorch port: its own copy of the configuration,
observability helpers and checkpoints."""
