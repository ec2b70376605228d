"""Share of the window spent in ``model.prefill`` calls (the harness's
synchronised wrapper), in percent."""

SOURCE = "host_clock"
LAYER = "model"
MOVES = "token_gap_p95_ms"


def read(r: dict):
    xs = r.get("prefill_s")
    if xs is None or not r.get("window_s"):
        return None
    return 100.0 * sum(xs) / r["window_s"]
