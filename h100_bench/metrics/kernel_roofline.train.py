"""The hand-written kernels' share of their roofline in the train loop: the
sum of every call's bound (bytes at 3.35 TB/s or operations at their type's
peak, from its shapes) over the sum of those calls' device time."""


def read(r):
    if r.loop != "train" or not r.kernel_calls:
        return None
    device = sum(c[2] for c in r.kernel_calls)
    return 100.0 * sum(c[1] for c in r.kernel_calls) / device if device > 0 else None
