"""Hand-written Hopper kernels of the main path, their wrappers and their
plain PyTorch versions (counterpart of ``repro.kernels``)."""
