"""The whole cloud tier's share of the card's bf16 peak: useful FLOPs of
the window's done frames, counted from each frame's frozen schedule
(``harness.flops.frame_flops``), over the window's wall time x 989 TFLOP/s,
in %."""
from harness.flops import PEAK_BF16


def read(obs):
    if obs["window_s"] <= 0 or not obs["frames_done"]:
        return None
    return obs["useful_flops"] / (obs["window_s"] * PEAK_BF16) * 100.0
