"""Model code of the port (ViT subset of ``repro.models``)."""
