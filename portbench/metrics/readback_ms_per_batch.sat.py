"""Host ms blocked in ToMe's device-to-host read-backs (the program's
``tome.readback`` span), per micro-batch of the traced stretch."""
from harness.program_spans import span_total, stretch


def read(obs):
    recs = stretch(obs)
    if not recs:
        return None
    return span_total(recs, "tome.readback")[1] / len(recs) * 1e3
