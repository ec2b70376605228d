"""The KDA prefill kernels' share of their roofline over the traced
sub-window: the least time of the chunked prefill's launches (the larger
of their FLOPs / 67 TFLOP/s, the CUDA cores' f32 rate their f32 state
keeps them on, and their bytes / 3.35 TB/s, from ``counts/kda_lm.py``
over the program's ``kda.scan_tokens`` counter and its ``kda.prefill``
spans) over the device time of their two kernels.

Launches are matched by name (``kda_intra_kernel`` and
``kda_state_kernel``); each call, a KDA layer's prefill (one
``kda.prefill`` span), launches each once, so both counts have to equal
the spans. A sub-window with no such call, or whose counts disagree,
reads nothing (never 0)."""

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
    calls = sum(1 for x in program.records() if x.name == "kda.prefill")
    tokens = program.counters().get("kda.scan_tokens", 0)
    intra_s, n_intra = trace.op_seconds("kda_intra_kernel")
    pass_s, n_pass = trace.op_seconds("kda_state_kernel")
    if not calls or not tokens or n_intra != calls or n_pass != calls:
        return None
    least = peaks.least_s(*kda_lm.chunk_prefill(r["config"], tokens, calls),
                          peaks.F32_FLOPS)
    return 100.0 * least / (intra_s + pass_s)
