"""Milliseconds a serving step spends admitting requests (prompt TX,
batch-1 prefills, the first token's read, the cache splice): the
program's ``serve.admit`` spans over the traced sub-window, over its
``serve.step`` spans (``repro_torch.utils.trace``)."""

SOURCE = "program_span"
LAYER = "scheduler"
MOVES = "token_gap_p95_ms"


def read(r: dict):
    try:
        from repro_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    recs = trace.records()
    steps = sum(1 for x in recs if x.name == "serve.step")
    if not steps:
        return None
    return sum(x.dur_ns for x in recs if x.name == "serve.admit") \
        / steps / 1e6
