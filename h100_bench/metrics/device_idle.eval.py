"""The share of the traced slice in which no operation ran on the card
(eval loop): one minus the union of device intervals over the slice."""


def read(r):
    if r.loop != "eval" or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
