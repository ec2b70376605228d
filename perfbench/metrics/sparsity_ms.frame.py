"""Milliseconds a call spends in the executor's sparsity pass (the
oracle that recomputes every layer on the card to count zeros): the
program's ``frame.sparsity`` spans over the traced sub-window, over its
``frame`` spans (``repro_torch.utils.trace``)."""

SOURCE = "program_span"
LAYER = "streaming executor"
MOVES = "device_us_per_frame"


def read(r: dict):
    try:
        from repro_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    recs = trace.records()
    calls = sum(1 for x in recs if x.name == "frame")
    if not calls:
        return None
    return sum(x.dur_ns for x in recs if x.name == "frame.sparsity") \
        / calls / 1e6
