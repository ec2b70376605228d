"""The whole call's share of the card's f32 peak over the traced
sub-window: the CNN's conv and classifier FLOPs of the frames classified
in it, over its length times 67 TFLOP/s."""

from perfbench.counts import cnn, peaks

SOURCE = "host_clock"
LAYER = "model step"
MOVES = "device_us_per_frame"


def read(r: dict):
    trace = r.get("trace")
    if trace is None or not r.get("sub_frames"):
        return None
    flops = r["sub_frames"] * cnn.frame_flops(r["config"])
    return 100.0 * flops / (trace.window_s * peaks.F32_FLOPS)
