"""Device-to-host read-backs (the program's ``host_syncs`` counter) over
the frames of the traced stretch."""
from harness.program_spans import counter_total, stretch


def read(obs):
    recs = stretch(obs)
    if not recs:
        return None
    return counter_total(recs, "host_syncs") / sum(r.frames for r in recs)
