"""The tome_scores kernels' share of their bound in the profiled stretch:
the bound of every merge layer's call (``harness.flops.tome_bound_s``) over
the profiler's time of the kernels named ``tome_scores*``, in %. Nothing in
a cell that does not merge."""


def read(obs):
    tr = obs.get("trace")
    if tr is None:
        return None
    calls, secs = tr.kernel_seconds("tome_scores")
    if not calls or secs <= 0:
        return None
    return obs["tome_bound_s"] / secs * 100.0
