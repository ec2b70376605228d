"""The KDA decode kernel's share of its roofline over the traced
sub-window: the least time of its launches (the larger of their FLOPs /
67 TFLOP/s f32 and their bytes / 3.35 TB/s, from ``counts/kda_lm.py``
over the program's ``kda.step`` counter and the cell's slots; the bytes,
each slot's state read and written, bound it) over their device time.

Launches are matched by name (``kda_step_kernel``); each call launches it
once, so the count has to equal the calls the program counted (a
replayed decode graph adds its captured calls). A sub-window with no such
call, or whose count disagrees, reads nothing (never 0)."""

from perfbench.counts import kda_lm, peaks

SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "tokens_per_s"


def read(r: dict):
    trace = r.get("trace")
    if trace is None:
        return None
    try:
        from repro_torch.utils import trace as program
    except ImportError:  # a program without the tracer
        return None
    calls = program.counters().get("kda.step", 0)
    step_s, n = trace.op_seconds("kda_step_kernel")
    if not calls or n != calls:
        return None
    least = peaks.least_s(*kda_lm.decode_step(
        r["config"], calls, r["traffic"]["n_slots"]), peaks.F32_FLOPS)
    return 100.0 * least / step_s
