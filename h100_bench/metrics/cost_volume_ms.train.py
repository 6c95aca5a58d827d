"""Device milliseconds a step in the two cost volumes, forward and
backward."""

RANGES = {"cost_volume": {"modules": ["cost_volume1", "cost_volume2"], "backward": True}}


def read(r):
    if r.loop != "train" or "cost_volume" not in r.range_s:
        return None
    return 1e3 * r.range_s["cost_volume"] / r.units
