"""Checkpointing of the port (counterpart of ``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpointer import Checkpointer
