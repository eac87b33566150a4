"""Sharding rules on torch DTensors (counterpart of ``repro.sharding``)."""
from repro_torch.sharding.rules import (PROFILES, Rules, constrain, current_rules,
                                        params_sharding)

__all__ = ["PROFILES", "Rules", "constrain", "current_rules", "params_sharding"]
