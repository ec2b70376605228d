"""The whole step's share of the card's bf16 peak: the model FLOPs of the
window's tokens (serving: the prefill of every admitted prompt and the
forward of every decoded token, over the context it sees), over the window
times 989 TFLOP/s, in percent."""

from perfbench.counts import peaks

SOURCE = "host_clock"
LAYER = "model step"
MOVES = "tokens_per_s"


def read(r: dict):
    if not r.get("model_flops") or not r.get("window_s"):
        return None
    return 100.0 * r["model_flops"] / (r["window_s"] * peaks.BF16_FLOPS)
