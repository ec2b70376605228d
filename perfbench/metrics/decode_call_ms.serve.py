"""Mean host milliseconds of one ``model.decode`` call, synchronised
before and after, timed by the harness's wrapper of the ``Model`` handed
to the engine (traced runs only)."""

SOURCE = "host_clock"
LAYER = "model"
MOVES = "token_gap_p95_ms"


def read(r: dict):
    xs = r.get("decode_s")
    if not xs:
        return None
    return sum(xs) / len(xs) * 1e3
