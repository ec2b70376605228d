"""Times a call blocks on the card (the program's ``wait.*`` counters:
the compute event, each copy's event, each ticket, each sparsity read),
over the traced sub-window's ``frame`` spans (``repro_torch.utils.trace``)."""

SOURCE = "program_counter"
LAYER = "streaming executor"
MOVES = "device_us_per_frame"


def read(r: dict):
    try:
        from repro_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    calls = sum(1 for x in trace.records() if x.name == "frame")
    if not calls:
        return None
    return sum(n for k, n in trace.counters().items()
               if k.startswith("wait.")) / calls
