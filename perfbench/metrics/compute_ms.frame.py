"""Mean over the window's calls of the sum of each layer's
``LayerTiming.compute_s`` (until the layer's output exists on the card),
the traced sub-window's calls left out."""

SOURCE = "program_span"
LAYER = "streaming executor"
MOVES = "device_us_per_frame"


def read(r: dict):
    xs = r.get("compute_s_per_call")
    if not xs:
        return None
    return sum(xs) / len(xs) * 1e3
