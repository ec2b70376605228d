"""Milliseconds of host time a serving step spends in KDA prefills (a
layer's convs, gates, chunked scan and gated norm, a layer at a time):
the program's ``kda.prefill`` spans over the traced sub-window, over its
``serve.step`` spans (``repro_torch.utils.trace``). A step that admitted
no request scans nothing and counts 0; a program without KDA, or a
sub-window without a step, reads nothing."""

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
    spans = [x.dur_ns for x in recs if x.name == "kda.prefill"]
    if not steps or not (spans or trace.counters().get("kda.step")):
        return None
    return sum(spans) / steps / 1e6
