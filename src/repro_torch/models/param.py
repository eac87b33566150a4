"""Declarative parameter specs, torch init, and the weight bridge from JAX.

Counterpart of ``repro.models.param``. A model is a nested dict of
``ParamSpec`` leaves; ``init_params`` materializes it with the reference's
init rules (normal 0.02, ``fan_in`` std, zeros, ones) from a
``torch.Generator`` — the same distributions as JAX, not the same numbers.
``from_jax_params`` takes the reference's own weights (a nested dict of
numpy arrays, or the flat ``"blocks/attn/wq"``-keyed dict that the
reference checkpointer writes to ``arrays.npz``) so a test can feed both
packages identical weights.

Layout is the reference's: ``[d_in, d_out]`` weights, ``blocks/*`` stacked
over layers, f32 master weights cast to the activation dtype at use.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.runtime.device import resolve_device

SEP = "/"  # key separator of the reference checkpointer's arrays.npz


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Any, ...]  # logical axis name (str) or None per dim
    dtype: torch.dtype = torch.float32
    init: str = "normal"  # normal | zeros | ones | fan_in | embed
    scale: float | None = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a nested dict (dict order preserved)."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def flatten(tree, prefix: str = "") -> dict[str, Any]:
    """Nested dict -> flat ``{"a/b/c": leaf}`` (the checkpointer's keys)."""
    flat: dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten(v, key))
        else:
            flat[key] = v
    return flat


def unflatten(flat: Mapping[str, Any]) -> dict:
    """Inverse of ``flatten``."""
    tree: dict = {}
    for key, v in flat.items():
        *path, last = key.split(SEP)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def _init_leaf(spec: ParamSpec, generator: torch.Generator) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype)
    if spec.init == "normal":
        std = spec.scale if spec.scale is not None else 0.02
    elif spec.init == "fan_in":
        fan_in = int(np.prod(spec.shape[:-1])) if len(spec.shape) > 1 else spec.shape[0]
        scale = spec.scale if spec.scale is not None else 1.0
        std = scale / math.sqrt(max(fan_in, 1))
    elif spec.init == "embed":
        std = spec.scale if spec.scale is not None else 1.0
    else:
        raise ValueError(f"unknown init {spec.init}")
    z = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (std * z).to(spec.dtype)


def init_params(specs, generator: torch.Generator, device=None, dtype=None) -> dict:
    """Materialize a spec tree on ``device`` (``cuda`` unless the caller
    passes ``device="cpu"``; raises if no card is there). Random leaves are
    drawn on the generator's device (a CUDA generator keeps a 300M-parameter
    init off the host) in spec-tree order. ``dtype`` overrides float leaves."""
    device = resolve_device(device)

    def leaf(spec: ParamSpec) -> torch.Tensor:
        t = _init_leaf(spec, generator).to(device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t

    return tree_map(leaf, specs)


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: torch.from_numpy refuses it
        return torch.from_numpy(arr.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True, order="C")).to(device)


def from_jax_params(tree: Mapping, device) -> dict:
    """The reference's param tree as the port's, on ``device``.

    ``tree`` is either nested (``jax.tree.map(np.asarray, params)``) or flat
    with ``"/"``-joined keys (``np.load(".../arrays.npz")``). Layouts and
    dtypes are kept exactly; values are copied bit for bit."""
    device = resolve_device(device)
    flat = dict(tree)
    if any(SEP in str(k) for k in flat):
        if any(isinstance(v, Mapping) for v in flat.values()):
            raise ValueError("mixed flat/nested param tree")
        tree = unflatten(flat)
    return tree_map(lambda a: _to_tensor(a, device), tree)


def stack_specs(n: int, make_one: Callable[[], dict]) -> dict:
    """Stack n copies of a spec tree along a leading 'layers' axis."""
    return tree_map(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                                        dtype=s.dtype, init=s.init, scale=s.scale),
                    make_one())


def layer_params(params: dict, l: int) -> dict:
    """Layer ``l``'s slice of the stacked ``blocks/*`` params (views)."""
    return tree_map(lambda a: a[l], params["blocks"])
