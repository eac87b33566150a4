"""Host ms in the program's ``tome.merge`` spans outside their
``tome.readback`` children, per micro-batch of the traced stretch: the cost
of issuing ToMe's matching and merge."""
from harness.program_spans import span_total, stretch


def read(obs):
    recs = stretch(obs)
    if not recs:
        return None
    merge = span_total(recs, "tome.merge")[1]
    readback = span_total(recs, "tome.readback")[1]
    return (merge - readback) / len(recs) * 1e3
