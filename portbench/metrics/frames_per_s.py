"""Frames whose logits reached the host in the window, over the window's
wall time (from its start to the end of its last dispatched micro-batch)."""


def read(obs):
    return obs["frames_done"] / obs["window_s"] if obs["window_s"] > 0 else None
