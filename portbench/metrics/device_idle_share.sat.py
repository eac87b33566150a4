"""The share of the profiled stretch in which no operation ran on the
card (torch.profiler), in %."""


def read(obs):
    tr = obs.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return (1.0 - tr.busy_s / tr.window_s) * 100.0
