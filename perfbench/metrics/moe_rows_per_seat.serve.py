"""Rows the MoE layers' expert products computed for each seat they served
in the traced sub-window: the program's ``moe.rows`` counter over its
``moe.seats`` (``repro_torch.utils.trace``). 1 where every expert ran over
its own seats alone; E / top_k where a dropless layer ran every expert
over a seat for every token. Nothing where the program keeps no such
counters."""

SOURCE = "program_counter"
LAYER = "model"
MOVES = "tokens_per_s"


def read(r: dict):
    try:
        from repro_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    counts = trace.counters()
    rows, seats = counts.get("moe.rows"), counts.get("moe.seats")
    if rows is None or not seats:
        return None
    return rows / seats
