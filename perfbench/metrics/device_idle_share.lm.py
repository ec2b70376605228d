"""1 - (the union of the device's busy intervals / the traced
sub-window), in percent."""

SOURCE = "device_trace"
LAYER = "device"
MOVES = "tokens_per_s"


def read(r: dict):
    trace = r.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
