"""The latent decode kernel's share of its roofline over the traced
sub-window: the least time of its launches (the larger of their FLOPs /
989 TFLOP/s bf16 and their bytes / 3.35 TB/s, from ``counts/mla_lm.py``
over the program's ``attn.latent_rows`` and ``attn.decode_latent``
counters) over the device time of its split and merge launches.

Launches are matched by name (``mla_decode_split`` and
``mla_decode_merge``); each call launches each once, so both counts have
to equal the calls the program counted (a replayed decode graph adds its
captured calls). A sub-window with no such call, with no rows counted, or
whose counts disagree, reads nothing."""

from perfbench.counts import mla_lm, peaks

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
    counts = program.counters()
    calls = counts.get("attn.decode_latent", 0)
    rows = counts.get("attn.latent_rows", 0)
    split_s, n_split = trace.op_seconds("mla_decode_split")
    merge_s, n_merge = trace.op_seconds("mla_decode_merge")
    if not calls or not rows or n_split != calls or n_merge != calls:
        return None
    least = peaks.least_s(*mla_lm.latent_decode(
        r["config"], rows, calls, r["traffic"]["n_slots"]), peaks.BF16_FLOPS)
    return 100.0 * least / (split_s + merge_s)
