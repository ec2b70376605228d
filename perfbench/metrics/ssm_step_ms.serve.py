"""Milliseconds of host time a serving step spends in Mamba2 decode
updates (each layer's one-token state step): the program's ``ssm.step``
spans over the traced sub-window, over its ``serve.step`` spans
(``repro_torch.utils.trace``); nothing where the program took no step."""

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
    spent = [x.dur_ns for x in recs if x.name == "ssm.step"]
    if not steps or not spent:
        return None
    return sum(spent) / steps / 1e6
