"""The one generator of frame traffic. A mix file (``traffic/<name>.json``)
gives its parameters:

- ``streams``: clients, each with one frame in flight, sending the next
  when its logits reach the host (a closed loop);
- ``mix``: the frame kinds, each a merge ``schedule`` (tokens merged at
  each layer, frozen from the planner's choice of ``alpha``) with the
  ``frames`` of that kind in each block of frames;
- ``max_batch``, ``max_wait_s``: the micro-batcher's limits.

Frames reach the cloud whole (split 0): the port's planner offloads no
other split (``PERF.md`` §4).

The seed picks each frame's kind and image. Every seed gets the same work
in another order: the kinds come in blocks of ``sum(frames)`` frames that
hold each kind's count exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from harness.weights import sub_seed


@dataclasses.dataclass
class Frame:
    fid: int
    kind: int         # index into the mix
    image: int        # index into the image pool
    due_s: float      # when it was sent (window-relative)
    dispatch_s: float | None = None
    done_s: float | None = None


def validate(traffic: dict, cfg: dict) -> None:
    if not all(isinstance(k["frames"], int) and k["frames"] > 0 for k in traffic["mix"]):
        raise ValueError("each kind of the mix needs a positive whole number of frames")
    for k in traffic["mix"]:
        if len(k["schedule"]) != cfg["num_hidden_layers"]:
            raise ValueError(f"schedule of alpha {k['alpha']} has {len(k['schedule'])} "
                             f"layers, the configuration {cfg['num_hidden_layers']}")
        left = cfg["num_tokens"]
        for r in k["schedule"]:
            if r and not 0 < r < (left + 1) // 2:
                raise ValueError(f"cannot merge {r} of {left} tokens")
            left -= r


class Source:
    """The frames of one run, drawn in order from the seed."""

    def __init__(self, traffic: dict, seed: int, stream: int = 2):
        self.traffic = traffic
        self.rng = np.random.Generator(np.random.PCG64(sub_seed(seed, stream)))
        self.kinds = np.repeat(np.arange(len(traffic["mix"])),
                               [k["frames"] for k in traffic["mix"]])
        self._block: list[int] = []
        self.count = 0

    def next(self, due_s: float) -> Frame:
        if not self._block:
            self._block = list(self.rng.permutation(self.kinds))
        kind = int(self._block.pop())
        image = int(self.rng.integers(self.traffic["image_pool"]))
        frame = Frame(self.count, kind, image, due_s)
        self.count += 1
        return frame
