"""Times a serving step blocks on the card (the program's ``wait.*``
counters: each ticket, each copy's event, each first token's read), over
the traced sub-window's ``serve.step`` spans (``repro_torch.utils.trace``)."""

SOURCE = "program_counter"
LAYER = "scheduler"
MOVES = "tokens_per_s"


def read(r: dict):
    try:
        from repro_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    steps = sum(1 for x in trace.records() if x.name == "serve.step")
    if not steps:
        return None
    return sum(n for k, n in trace.counters().items()
               if k.startswith("wait.")) / steps
