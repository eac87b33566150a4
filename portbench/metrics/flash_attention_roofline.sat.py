"""The flash kernels' share of their bound in the profiled stretch: the
bound of every call made (``harness.flops.flash_bound_s`` at its token
count) over the profiler's time of the kernels named ``flash*``, in %."""


def read(obs):
    tr = obs.get("trace")
    if tr is None:
        return None
    calls, secs = tr.kernel_seconds("flash")
    if not calls or secs <= 0:
        return None
    return obs["flash_bound_s"] / secs * 100.0
