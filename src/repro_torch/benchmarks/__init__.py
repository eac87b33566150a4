"""Readers of the port's dry-run and hill-climb records (``experiments/torch/``)."""
