"""Serving tier: request batching (``batcher``), SLA classes (``sla``), the
multi-stream fleet runtime (``fleet``), and declarative workload scenarios
(``workload``). PyTorch port of ``repro.serving``: the same names, with the
port's engine underneath."""
from repro_torch.serving.batcher import (ContinuousBatcher, KVSlotManager,
                                   MicroBatcher, PriorityMicroBatcher,
                                   Request)
from repro_torch.serving.fleet import (AutoscaleConfig, Autoscaler, ClassStats,
                                 CloudTierConfig, FleetRuntime, FleetStats,
                                 RegionSpec, RegionStats, StreamSpec,
                                 default_cloud_config)
from repro_torch.serving.sla import (DEFAULT_SLA_CLASSES, SlaClass,
                               resolve_sla_class)
from repro_torch.serving.workload import (ArrivalConfig, DeviceTier, DEVICE_TIERS,
                                    NetworkConfig, RegionConfig, WorkloadSpec,
                                    arrival_times, build_runtime,
                                    stream_seeds, tier_profile)

__all__ = [
    "ContinuousBatcher", "KVSlotManager", "MicroBatcher",
    "PriorityMicroBatcher", "Request",
    "AutoscaleConfig", "Autoscaler", "ClassStats", "CloudTierConfig",
    "FleetRuntime", "FleetStats", "RegionSpec", "RegionStats", "StreamSpec",
    "default_cloud_config",
    "DEFAULT_SLA_CLASSES", "SlaClass", "resolve_sla_class",
    "ArrivalConfig", "DeviceTier", "DEVICE_TIERS", "NetworkConfig",
    "RegionConfig", "WorkloadSpec", "arrival_times", "build_runtime",
    "stream_seeds", "tier_profile",
]
