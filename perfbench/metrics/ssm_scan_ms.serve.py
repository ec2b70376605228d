"""Milliseconds of host time a serving step spends in Mamba2 scans (a
prefill's conv, SSD and gated norm, a layer at a time): the program's
``ssm.scan`` spans over the traced sub-window, over its ``serve.step``
spans (``repro_torch.utils.trace``). A step that admitted no request
scans nothing and counts 0."""

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
    return sum(x.dur_ns for x in recs if x.name == "ssm.scan") / steps / 1e6
