"""Optimizer and gradient compression of the port (counterpart of
``repro.optim``)."""
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
