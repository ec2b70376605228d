"""Milliseconds of host time a serving step spends in latent attention's
prefill (a layer's cache write, decompression of K and V and attention,
through the plain routes): the program's ``mla.prefill`` spans over the
traced sub-window, over its ``serve.step`` spans
(``repro_torch.utils.trace``). A sub-window without such a span (no
prefill in it, or a program without latent attention) reads nothing."""

SOURCE = "program_span"
LAYER = "model"
MOVES = "tokens_per_s"


def read(r: dict):
    try:
        from repro_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    recs = trace.records()
    steps = sum(1 for x in recs if x.name == "serve.step")
    spans = [x.dur_ns for x in recs if x.name == "mla.prefill"]
    if not steps or not spans:
        return None
    return sum(spans) / steps / 1e6
