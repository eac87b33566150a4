"""PyTorch/CUDA port of the Janus split-ViT serving system.

Mirrors ``src/repro/`` module by module (``repro_torch.core.tome`` is the
counterpart of ``repro.core.tome``) and imports nothing of it: the JAX
package is the reference the port is tested against, not a dependency.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
the two hot kernels of the main path (flash attention and ToMe scores) are
hand-written CUDA C++ for Hopper under ``kernels/csrc``.
"""
