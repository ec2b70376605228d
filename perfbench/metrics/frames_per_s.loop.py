"""Frames classified a second by the closed loop, over the window's
untraced calls and their time: the rate the sensor's host sees, by the
host's clock (its runs spread with the host's load, so it is read here
and not held end to end)."""

SOURCE = "host_clock"
LAYER = "streaming executor"
MOVES = "device_us_per_frame"


def read(r: dict):
    return r.get("frames_per_s.loop")
