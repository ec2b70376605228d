"""95th percentile of a call's time over the window's untraced calls:
from handing the frames to ``run_frame`` until the logits are on the
host, by the host's clock (held per layer, as ``frames_per_s.loop``)."""

SOURCE = "host_clock"
LAYER = "streaming executor"
MOVES = "device_us_per_frame"


def read(r: dict):
    return r.get("frame_p95_ms.loop")
