"""Device microseconds a serving step spends in the decode-attention
kernel: its split and merge launches over the traced sub-window, matched
by name (``decode_attention_split`` and ``decode_attention_merge``), over
the program's ``serve.step`` spans.

The program ticks its ``attn.decode`` counter once a decode-attention
call (each call one split and one merge launch; a replayed decode graph
adds its captured calls), so both launch counts have to equal it; a
sub-window without such calls, or a trace whose counts disagree, reads
nothing."""

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
    steps = sum(1 for x in program.records() if x.name == "serve.step")
    calls = program.counters().get("attn.decode", 0)
    split_s, n_split = trace.op_seconds("decode_attention_split")
    merge_s, n_merge = trace.op_seconds("decode_attention_merge")
    if not steps or not calls or n_split != calls or n_merge != calls:
        return None
    return 1e6 * (split_s + merge_s) / steps
