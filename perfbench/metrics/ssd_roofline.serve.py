"""The SSD kernels' share of their roofline over the traced sub-window:
the least time of the intra-chunk kernel's and the state pass's launches
(each the larger of its FLOPs / 989 TFLOP/s bf16 and its bytes / 3.35
TB/s, from ``counts/hybrid_lm.py`` over the program's ``ssm.scan_tokens``
counter and its ``ssm.scan`` spans) over their device time.

Launches are matched by name (``ssd_chunk`` holds the bf16 and f32
intra-chunk kernels, ``ssd_state_pass`` the pass); each scan launches each
once, so both counts have to equal the scans the program recorded. A
sub-window with no scan, or a trace whose counts disagree, reads
nothing."""

from perfbench.counts import hybrid_lm, peaks

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
    scans = sum(1 for x in program.records() if x.name == "ssm.scan")
    tokens = program.counters().get("ssm.scan_tokens", 0)
    intra_s, n_intra = trace.op_seconds("ssd_chunk")
    pass_s, n_pass = trace.op_seconds("ssd_state_pass")
    if not scans or not tokens or n_intra != scans or n_pass != scans:
        return None
    cfg = r["config"]
    least = (peaks.least_s(*hybrid_lm.intra_chunk(cfg, tokens),
                           peaks.BF16_FLOPS)
             + peaks.least_s(*hybrid_lm.state_pass(cfg, tokens, scans),
                             peaks.BF16_FLOPS))
    return 100.0 * least / (intra_s + pass_s)
