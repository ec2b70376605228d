"""Share of the traced sub-window's serving steps whose decode was replayed
from the captured CUDA graph: the program's ``serve.graph_replay`` counter
over its ``serve.step`` spans (``repro_torch.utils.trace``), in percent;
nothing where the program keeps no such counter."""

SOURCE = "program_counter"
LAYER = "model"
MOVES = "tokens_per_s"


def read(r: dict):
    try:
        from repro_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    steps = sum(1 for x in trace.records() if x.name == "serve.step")
    replays = trace.counters().get("serve.graph_replay")
    if not steps or replays is None:
        return None
    return 100.0 * replays / steps
