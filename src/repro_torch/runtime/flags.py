"""Runtime flags, PyTorch port of ``repro.runtime.flags``.

The reference's ``unrolled_costs`` makes its dry-run lower layer-stack
scans fully unrolled, because XLA's cost analysis visits a while-loop body
once and would count a 30-layer scan as one layer. The port runs eagerly:
every layer's operations are dispatched, and the per-rank counter
(``runtime.hlo_bytes``) sees each of them, so there is no scan to
under-count. ``unrolled_costs`` is kept as a context manager that changes
nothing, and ``layer_unroll`` always returns the layer count, so that
callers written against the reference read the same.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def unrolled_costs(on: bool = True):
    """A no-op scope: eager PyTorch already runs (and counts) every layer."""
    yield


def layer_unroll(n_layers: int) -> int:
    """Every layer runs: the whole stack, whatever the scope."""
    return n_layers
