"""Exposed RX wait per byte over the window's calls (``FrameTiming``'s
``rx_us_per_byte``), the traced sub-window's calls left out."""

SOURCE = "program_span"
LAYER = "transfer engine"
MOVES = "device_us_per_frame"


def read(r: dict):
    if not r.get("rx_bytes"):
        return None
    return r["rx_s"] * 1e6 / r["rx_bytes"]
