"""Mean host ms of one stacked forward (the program's ``engine.forward``
span, its read-back waits included) over the traced stretch."""
from harness.program_spans import span_total, stretch


def read(obs):
    recs = stretch(obs)
    if not recs:
        return None
    n, s = span_total(recs, "engine.forward")
    return s / n * 1e3 if n else None
