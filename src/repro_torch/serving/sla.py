"""SLA classes for the serving tier: named priority/deadline policies.
Port of ``repro.serving.sla`` (pure Python, copied unchanged).

Janus's headline metric is the latency-violation ratio under dynamic
networks, but not every stream has the same deadline economics: an
interactive AR stream is worthless 150 ms late, while a batch analytics
stream only cares about throughput. An ``SlaClass`` names that contract:

  * ``priority``        — admission rank (0 = most urgent). The priority
    micro-batcher orders flushes by (aged priority, deadline slack).
  * ``sla_multiplier``  — scales the fleet/stream base SLA into this class's
    deadline (interactive 0.5x = half the base budget; batch 4x).
  * ``wait_multiplier`` — scales the micro-batcher's deadline window: an
    interactive frame may only be held ``0.25 * max_wait_s`` for batching,
    a batch frame rides ``4x`` longer to form bigger, cheaper batches.

The default registry (``DEFAULT_SLA_CLASSES``) is ``interactive`` /
``standard`` / ``batch``. ``standard`` is the identity class: multipliers of
1.0 reproduce the FIFO fleet's behavior exactly (the single-class
regression test in ``tests/test_priority_batcher.py`` pins this bit-exact).

Class sets are JSON-loadable (``WorkloadSpec.sla_class_defs``): a mapping of
``name -> {priority, sla_multiplier, wait_multiplier}`` merged over the
defaults, so a spec can both retune the built-ins and add new classes.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class SlaClass:
    """One serving contract (see module docstring)."""
    name: str
    priority: int               # 0 = most urgent; larger = yields to smaller
    sla_multiplier: float = 1.0
    wait_multiplier: float = 1.0

    def __post_init__(self):
        if not self.name:
            raise ValueError("SlaClass needs a non-empty name")
        if self.priority < 0:
            raise ValueError(f"priority must be >= 0, got {self.priority}")
        if self.sla_multiplier <= 0:
            raise ValueError(
                f"sla_multiplier must be > 0, got {self.sla_multiplier}")
        if self.wait_multiplier < 0:
            raise ValueError(
                f"wait_multiplier must be >= 0, got {self.wait_multiplier}")


DEFAULT_SLA_CLASSES: dict[str, SlaClass] = {
    "interactive": SlaClass("interactive", priority=0,
                            sla_multiplier=0.5, wait_multiplier=0.25),
    "standard": SlaClass("standard", priority=1,
                         sla_multiplier=1.0, wait_multiplier=1.0),
    "batch": SlaClass("batch", priority=2,
                      sla_multiplier=4.0, wait_multiplier=4.0),
}

#: the identity class every stream gets unless told otherwise
DEFAULT_CLASS = "standard"


def resolve_sla_class(cls: str | SlaClass,
                      classes: Mapping[str, SlaClass] | None = None) -> SlaClass:
    """Look up a class by name (or pass an SlaClass through)."""
    if isinstance(cls, SlaClass):
        return cls
    table = classes if classes is not None else DEFAULT_SLA_CLASSES
    try:
        return table[cls]
    except KeyError:
        raise ValueError(f"unknown SLA class {cls!r}; known: "
                         f"{sorted(table)}") from None


def classes_from_dict(d: Mapping[str, Mapping] | None) -> dict[str, SlaClass]:
    """The default registry overlaid with JSON-style per-class overrides.

    ``d`` maps class name -> field dict (``priority`` required for new
    classes; omitted fields of a known class keep that class's defaults).
    """
    out = dict(DEFAULT_SLA_CLASSES)
    for name, fields in (d or {}).items():
        fields = dict(fields)
        unknown = set(fields) - {"priority", "sla_multiplier",
                                 "wait_multiplier"}
        if unknown:
            raise ValueError(f"unknown SlaClass keys {sorted(unknown)} "
                             f"for class {name!r}")
        base = out.get(name)
        if base is not None:
            out[name] = dataclasses.replace(base, **fields)
        else:
            if "priority" not in fields:
                raise ValueError(f"new SLA class {name!r} needs a priority")
            out[name] = SlaClass(name=name, **fields)
    return out


def classes_to_dict(classes: Mapping[str, SlaClass]) -> dict[str, dict]:
    """JSON-serializable form of a class registry (only non-default entries
    need shipping, but serializing everything round-trips cleanly)."""
    return {name: {"priority": c.priority,
                   "sla_multiplier": c.sla_multiplier,
                   "wait_multiplier": c.wait_multiplier}
            for name, c in classes.items()}
