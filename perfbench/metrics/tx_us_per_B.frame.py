"""Exposed TX wait per byte over the window's calls (``FrameTiming``'s
``tx_us_per_byte``, Table I's quantity), the traced sub-window's calls
left out."""

SOURCE = "program_span"
LAYER = "transfer engine"
MOVES = "device_us_per_frame"


def read(r: dict):
    if not r.get("tx_bytes"):
        return None
    return r["tx_s"] * 1e6 / r["tx_bytes"]
