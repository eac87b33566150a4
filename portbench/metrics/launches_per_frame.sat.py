"""Device kernels launched in the profiled stretch, over the frames it
dispatched."""


def read(obs):
    tr = obs.get("trace")
    if tr is None or not obs.get("trace_frames"):
        return None
    return tr.launches / obs["trace_frames"]
