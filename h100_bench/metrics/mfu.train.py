"""The training step's share of the card's bf16 dense peak: one step's
forward and backward FLOPs (counted over the plain reference at the cell's
shapes) times the untraced window's steps a second, over 989e12."""


def read(r):
    if r.loop != "train" or not r.flops_per_unit:
        return None
    return 100.0 * r.flops_per_unit * r.units_per_s / r.peak_flops
