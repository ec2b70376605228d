"""Milliseconds of host time inside the model's decode call a serving
step: the program's ``lm.decode`` spans over the traced sub-window, over
its ``serve.step`` spans (``repro_torch.utils.trace``). The traced run's
wrapper of the ``Model`` synchronises the card before the call, and the
call returns once its work is queued, so the span is the host's dispatch
of the decode."""

SOURCE = "program_span"
LAYER = "model"
MOVES = "tokens_per_s"


def read(r: dict):
    try:
        from repro_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    recs = trace.records()
    steps = sum(1 for x in recs if x.name == "serve.step")
    if not steps:
        return None
    return sum(x.dur_ns for x in recs if x.name == "lm.decode") \
        / steps / 1e6
