"""Mean over the window's engine steps of ``step()``'s active count over
``n_slots``, in percent."""

SOURCE = "program_counter"
LAYER = "scheduler"
MOVES = "tokens_per_s"


def read(r: dict):
    if "slot_occupancy" not in r:
        return None
    return 100.0 * r["slot_occupancy"]
