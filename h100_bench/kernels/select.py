"""The window selection multiplicities (csrc/select.cu): per slot its
distance and validity (13 f32 operations) and, for every query with a
valid slot, one pass of 2 per slot that selects; the grid read once and m
written once. The count of queries with a valid slot is read from the
result after the traced slice (``bound`` returns a deferred count)."""

from h100_bench.work import F32_FLOPS, bound as _bound, nbytes

MODULE, FUNCTION = "i2pnet_tpu_torch.ops.select_cuda", "selection_multiplicity_cuda"


def bound(a, m):
    S = a[4][0] * a[4][1]
    found = ((m[..., :S] > 0).sum(-1) > 0).sum()  # stays on the device until read
    fixed = 13.0 * m.shape[0] * m.shape[1] * S
    byte_count = nbytes(a[0], m)
    return lambda: _bound(byte_count, fixed + 2.0 * S * float(found), F32_FLOPS)

