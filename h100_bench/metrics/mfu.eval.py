"""The evaluation's share of the card's bf16 dense peak: the cascade's
FLOPs a batch (counted over the plain reference at the cell's shapes) times
the untraced window's batches a second, over 989e12."""


def read(r):
    if r.loop != "eval" or not r.flops_per_unit:
        return None
    return 100.0 * r.flops_per_unit * r.units_per_s / r.peak_flops
