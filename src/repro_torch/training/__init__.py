"""Training-side code of the port (counterpart of ``repro.training``)."""
