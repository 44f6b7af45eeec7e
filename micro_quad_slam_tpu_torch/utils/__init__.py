"""Utilities of the PyTorch port: its own copy of the configuration,
the entry points' default device, observability helpers and checkpoints."""
