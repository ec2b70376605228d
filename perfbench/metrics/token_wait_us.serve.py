"""Microseconds the host waits for a step's tokens: the program's
``serve.token_rx`` spans (the RX submission until the last ticket
returns: queue, copy and wake-ups) over the traced sub-window, over its
``serve.step`` spans (``repro_torch.utils.trace``)."""

SOURCE = "program_span"
LAYER = "transfer engine"
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
    return sum(x.dur_ns for x in recs if x.name == "serve.token_rx") \
        / steps / 1e3
