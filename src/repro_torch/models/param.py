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


def _std(spec: ParamSpec) -> float:
    """The reference's std of a random leaf. ``fan_in`` is the product of
    every axis but the last, of the whole (stacked) shape."""
    if spec.init == "normal":
        return spec.scale if spec.scale is not None else 0.02
    if spec.init == "fan_in":
        fan_in = int(np.prod(spec.shape[:-1])) if len(spec.shape) > 1 else spec.shape[0]
        scale = spec.scale if spec.scale is not None else 1.0
        return scale / math.sqrt(max(fan_in, 1))
    if spec.init == "embed":
        return spec.scale if spec.scale is not None else 1.0
    raise ValueError(f"unknown init {spec.init}")


def _init_leaf(spec: ParamSpec, generator: torch.Generator, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    """One leaf in ``dtype`` on ``device``. A leaf stacked over layers is
    drawn a layer at a time (f32 on the generator's device, then cast into
    the leaf), so no f32 copy of the whole leaf exists: one qwen3 expert
    leaf is 38.7 GB in f32."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    std = _std(spec)

    def draw(shape):
        z = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return std * z

    if not spec.axes or spec.axes[0] != "layers":
        return draw(spec.shape).to(device=device, dtype=dtype)
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    for l in range(spec.shape[0]):
        out[l] = draw(spec.shape[1:])
    return out


def init_params(specs, generator: torch.Generator, device=None, dtype=None) -> dict:
    """Materialize a spec tree on ``device`` (``cuda`` unless the caller
    passes ``device="cpu"``; raises if no card is there). Random leaves are
    drawn on the generator's device (a CUDA generator keeps a 30B-parameter
    init off the host) in spec-tree order, stacked leaves a layer at a time.
    ``dtype`` overrides float leaves."""
    device = resolve_device(device)

    def leaf(spec: ParamSpec) -> torch.Tensor:
        out_dtype = spec.dtype
        if dtype is not None and spec.dtype.is_floating_point:
            out_dtype = dtype
        return _init_leaf(spec, generator, device, out_dtype)

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


def _spec_leaves(specs) -> list[ParamSpec]:
    if isinstance(specs, Mapping):
        return [s for v in specs.values() for s in _spec_leaves(v)]
    return [specs]


def param_count(specs) -> int:
    """Number of parameters in a spec tree."""
    return sum(int(np.prod(s.shape)) for s in _spec_leaves(specs))


def param_bytes(specs, dtype=None) -> int:
    """Bytes of a spec tree's params; ``dtype`` overrides float leaves, as
    ``init_params``'s."""
    total = 0
    for s in _spec_leaves(specs):
        dt = dtype if dtype is not None and s.dtype.is_floating_point else s.dtype
        total += int(np.prod(s.shape)) * dt.itemsize
    return total


def abstract_params(specs, dtype=None) -> dict:
    """The spec tree as meta-device tensors (shapes and dtypes, no memory),
    ``dtype`` overriding float leaves."""
    def leaf(spec: ParamSpec) -> torch.Tensor:
        dt = dtype if dtype is not None and spec.dtype.is_floating_point else spec.dtype
        return torch.empty(spec.shape, dtype=dt, device="meta")
    return tree_map(leaf, specs)


def stack_specs(n: int, make_one: Callable[[], dict]) -> dict:
    """Stack n copies of a spec tree along a leading 'layers' axis."""
    return tree_map(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                                        dtype=s.dtype, init=s.init, scale=s.scale),
                    make_one())


def layer_params(params: dict, l: int, key: str = "blocks") -> dict:
    """Layer ``l``'s slice of the params stacked under ``key`` (views)."""
    return tree_map(lambda a: a[l], params[key])
