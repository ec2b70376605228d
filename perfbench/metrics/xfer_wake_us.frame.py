"""Mean microseconds from a transfer's completion event being set until
its waiting caller runs again, over the traced sub-window's calls: the
program's ``xfer.wake`` marks, over the descriptors
(``repro_torch.utils.trace``). Nothing where the program keeps no such
marks or no ``frame`` span ran."""

SOURCE = "program_span"
LAYER = "transfer engine"
MOVES = "device_us_per_frame"
PHASE = "xfer.wake"


def read(r: dict):
    try:
        from repro_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    recs = trace.records()
    durs = [x.dur_ns for x in recs if x.name == PHASE]
    if not durs or not any(x.name == "frame" for x in recs):
        return None
    return sum(durs) / len(durs) / 1e3
