"""Device resolution and parity numerics.

Every entry point of the port takes an explicit ``device``; the default is
``cuda`` and there is no silent CPU fallback: asking for a card that is not
there raises. Tests and CPU runs pass ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device`` (``cuda`` when None). Raises if a CUDA
    device is asked for and PyTorch sees no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


def require_on(device: torch.device, tensors: dict[str, torch.Tensor]) -> None:
    """Raise unless every tensor lies on ``device`` (``cuda`` without an index
    matches any card). Entry points never move work between devices."""
    for name, t in tensors.items():
        if t.device.type != device.type or (
                device.index is not None and t.device.index != device.index):
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def parity_numerics() -> None:
    """Full-precision f32 products on the card: no TF32 in matmuls or cuDNN.
    Used wherever f32 results are held against a reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
