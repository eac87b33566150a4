"""Janus core, PyTorch port (counterpart of ``repro.core``).

The host control plane (pruning, splitter, profiler, scheduler, planner,
bucketing, bandwidth, compression) is a numpy copy of the reference; tome
and engine run the model math in torch. Submodules are imported on use.
"""
