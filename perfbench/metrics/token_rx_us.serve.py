"""Microseconds of token RX a step: the ``TransferStats.wall_s`` of the
window's RX records on the engine's ``TransferEngine``, summed, over the
window's steps."""

SOURCE = "program_counter"
LAYER = "transfer engine"
MOVES = "token_gap_p95_ms"


def read(r: dict):
    if not r.get("rx_records") or not r.get("steps"):
        return None
    return r["token_rx_s"] * 1e6 / r["steps"]
