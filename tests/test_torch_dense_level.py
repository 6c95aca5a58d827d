"""The dense eval level pass by pass (``ops/dense_level_cuda.py``, the op
``i2pnet::dense_level_pass`` and ``dense_window.dense_level_passes``) on the
CPU, where the op runs its plain version: the 2L + 1 passes against the
plain chain of ``dense_pointnet_eval`` in every mode, the passes under a
two-rank mesh against one process on the union of the rows, and the gate
that sends a call to the plain chain and counts why. The kernel itself is
held against the plain version on the card
(``tests/test_torch_cuda_kernels.py``). Imports no jax.
"""

import numpy as np
import pytest
import torch

from i2pnet_tpu_torch.nn.proj_backbone import ProjectPointNet
from i2pnet_tpu_torch.ops import dense_level_cuda, dense_window

GEOMETRY = dict(out_h=4, out_w=8, stride_h=2, stride_w=2, kernel_size=(3, 5), nsample=4,
                distance=1.5)


def level_inputs(seed, B=2, H=8, W=16, cf=3, widths=(8, 16)):
    """Grids with holes (raw, warped, feature) and a level's layers with a
    non-trivial normalisation affine."""
    rng = np.random.default_rng(seed)
    xyz_raw = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    holes = rng.random((B, H, W)) < 0.3
    xyz_raw[holes] = 0.0
    xyz = xyz_raw + rng.normal(size=(B, H, W, 3)).astype(np.float32) * 0.05
    xyz[holes] = 0.0
    feat = rng.normal(size=(B, H, W, cf)).astype(np.float32)
    return xyz_raw, xyz, feat, rng


def level_layers(rng, cin, widths):
    layers = []
    for cout in widths:
        layers.append(tuple(torch.from_numpy(a.astype(np.float32)) for a in (
            rng.normal(size=(cout, cin)) / np.sqrt(cin), rng.normal(size=cout) * 0.1,
            1.0 + 0.2 * rng.normal(size=cout), 0.1 * rng.normal(size=cout))))
        cin = cout
    return layers


MODES = {  # mode: (center_mode, dist_mode, using_intens, grouped width)
    "center": (True, False, False, 10),
    "center_intens": (True, False, True, 13),
    "dist": (False, True, False, 1),
    "diff_feature": (False, False, False, 6),
}


@pytest.mark.parametrize("mode,raw_feat_point,dtype", [
    ("center", True, None), ("center_intens", True, None), ("dist", True, None),
    ("diff_feature", True, None), ("diff_feature", False, None), ("center", True, "bf16"),
    ("diff_feature", True, "bf16"),
])
def test_passes_equal_the_plain_chain(mode, raw_feat_point, dtype):
    """dense_level_passes (2L + 1 passes of the op's plain version) gives the
    plain chain's features: within 1e-6 x max(|ref|, 1) in f32 (the
    statistics' order of summation alone differs: per batch row, then over
    the rows); in bf16 the card tests' bar, 0.01 x max(|ref|, 1)."""
    center_mode, dist_mode, using_intens, width = MODES[mode]
    xyz_raw, xyz, feat, rng = level_inputs(3)
    layers = level_layers(rng, width, (8, 16, 24))
    bf16 = dtype == "bf16"
    kw = dict(GEOMETRY, center_mode=center_mode, dist_mode=dist_mode, using_intens=using_intens,
              raw_feat_point=raw_feat_point, dtype=torch.bfloat16 if bf16 else None)
    grids = [torch.from_numpy(a) for a in (xyz_raw, xyz, feat)]
    before = dict(dense_level_cuda.routes)
    ref = dense_window.dense_pointnet_eval(*grids, layers, **kw)[2]
    assert dense_level_cuda.routes["plain:cpu" if bf16 else "plain:float32"] == \
        before.get("plain:cpu" if bf16 else "plain:float32", 0) + 1
    m = dense_window.window_multiplicity(
        grids[1], out_h=4, out_w=8, qstride=(2, 2), kernel_size=(3, 5), K=4, distance=1.5)
    launches = dense_level_cuda.launches
    got = dense_window.dense_level_passes(
        grids[0] if raw_feat_point else grids[1], grids[1], grids[2], m, layers, out_h=4,
        out_w=8, qstride=(2, 2), kernel_size=(3, 5), nsample=4, mode=mode, bf16=bf16)
    assert dense_level_cuda.launches == launches  # CPU: the plain version
    assert got.shape == ref.shape == (2, 4, 8, 24) and got.dtype == torch.float32
    bar = (0.01 if bf16 else 1e-6) * max(float(ref.abs().max()), 1.0)
    assert float((got - ref).abs().max()) <= bar


def test_pass_sums_are_per_batch_row():
    """A mean pass gives each batch row's m-weighted sums: summed over the
    rows and divided by B*N*K they are the chain's first-layer mean."""
    xyz_raw, xyz, feat, rng = level_inputs(5)
    layers = level_layers(rng, 10, (8, 16))
    g = [torch.from_numpy(a) for a in (xyz_raw, xyz, feat)]
    m = dense_window.window_multiplicity(
        g[1], out_h=4, out_w=8, qstride=(2, 2), kernel_size=(3, 5), K=4, distance=1.5)
    w, b, s, h = (list(x) for x in zip(*layers))
    sums = torch.ops.i2pnet.dense_level_pass(g[0], g[1], g[2], m, w, b, s, h, [], 1.0, 4, 8,
                                             [2, 2], [3, 5], 4, "center", False, 0,
                                             dense_level_cuda.MEAN, 1e-5)
    x = dense_level_cuda.grouped_features(g[0], g[1], g[2], 4, 8, (2, 2), (3, 5), "center")
    h0 = x @ w[0].t() + b[0]
    assert sums.shape == (2, 8)
    np.testing.assert_allclose(sums.numpy(), (h0 * m[..., None]).sum((1, 2)).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_passes_under_a_mesh_equal_one_process(tmp_path):
    """Under a two-rank gloo mesh, three rows fanned out as 2 + (1 real, 1
    repeated), the passes average each pass's sums over the real rows
    (``global_means``) and give one process's features on the union of the
    rows."""
    from _torch_dp_worker import spawn

    xyz_raw, xyz, feat, rng = level_inputs(7, B=3, cf=5)
    layers = level_layers(rng, 8, (8, 16))
    arrays = [[a.numpy() for a in layer] for layer in layers]
    g = [torch.from_numpy(a) for a in (xyz_raw, xyz, feat)]
    m = dense_window.window_multiplicity(
        g[1], out_h=4, out_w=8, qstride=(2, 2), kernel_size=(3, 5), K=4, distance=1.5)
    ref = dense_window.dense_level_passes(g[0], g[1], g[2], m, layers, out_h=4, out_w=8,
                                          qstride=(2, 2), kernel_size=(3, 5), nsample=4,
                                          mode="diff_feature", bf16=False)
    ranks = spawn(tmp_path, "dense_passes", 3, (xyz_raw, xyz, feat), arrays)
    got = torch.cat([r["feat"][:r["valid"]] for r in ranks])
    assert [r["valid"] for r in ranks] == [2, 1]
    assert float((got - ref).abs().max()) <= 1e-6 * max(float(ref.abs().max()), 1.0)


@pytest.mark.parametrize("widths,reason", [((8, 12), "width"), ((8, 264), "width"),
                                           ((8, 8, 8, 8, 8), "depth"), ((8, 16), "cpu")])
def test_gate_counts_why_the_plain_chain_ran(widths, reason):
    """A bf16 level the kernel was not built for (a width not a multiple of
    8 or above 256, more than 4 layers) or on the CPU runs the plain chain,
    and ``routes`` counts the reason; the module on its dense eval route goes
    through the same gate."""
    xyz_raw, xyz, feat, _ = level_inputs(9)
    g = [torch.from_numpy(a) for a in (xyz_raw, xyz, feat)]
    torch.manual_seed(0)
    mod = ProjectPointNet(4, 8, 2, 2, (3, 5), 4, 1.5, widths, 10, dtype=torch.bfloat16).eval()
    before = dense_level_cuda.routes["plain:" + reason]
    with torch.no_grad():
        _, _, out = mod(*g, center_mode=True)
    assert dense_level_cuda.routes["plain:" + reason] == before + 1
    assert out.shape == (2, 4, 8, widths[-1]) and bool(torch.isfinite(out).all())


def test_gate_refusals():
    """The gate's other reasons: more selected slots than a query's 32 rows,
    a window of more than 255 slots, an f32 level, a feature grid whose
    channels are strided."""
    xyz_raw, xyz, feat, _ = level_inputs(9)
    g = [torch.from_numpy(a) for a in (xyz_raw, xyz, feat)]
    m = torch.zeros(2, 32, 16)
    w = [torch.zeros(8, 10), torch.zeros(16, 8)]
    refusal = dense_level_cuda.refusal
    assert refusal(g[0], g[1], g[2], m, w, 40, torch.bfloat16) == "nsample"
    assert refusal(g[0], g[1], g[2], torch.zeros(2, 32, 17 * 17 + 1), w, 4,
                   torch.bfloat16) == "window"
    assert refusal(g[0], g[1], g[2], m, w, 4, None) == "float32"
    assert refusal(g[0], g[1], g[2][..., ::2], m, w, 4, torch.bfloat16) == "layout"
    assert refusal(g[0], g[1], g[2], m, w, 4, torch.bfloat16) == "cpu"


def test_gate_keeps_a_gradient_on_the_plain_chain():
    """An eval-mode bf16 level with grad on, whose parameters require grad,
    runs the differentiable plain chain (``routes`` counts ``grad``), and
    backward reaches its weights; a bias alone requiring grad is enough;
    under no_grad the same call meets the gate's other reasons."""
    xyz_raw, xyz, feat, _ = level_inputs(9)
    g = [torch.from_numpy(a) for a in (xyz_raw, xyz, feat)]
    torch.manual_seed(0)
    mod = ProjectPointNet(4, 8, 2, 2, (3, 5), 4, 1.5, (8, 16), 10, dtype=torch.bfloat16).eval()
    before = dense_level_cuda.routes["plain:grad"]
    _, _, out = mod(*g, center_mode=True)
    assert dense_level_cuda.routes["plain:grad"] == before + 1
    out.square().sum().backward()
    grad = mod.mlp_convs.layers[0].Dense_0.weight.grad
    assert grad is not None and bool(torch.isfinite(grad).all()) and float(grad.abs().sum()) > 0

    m = torch.zeros(2, 32, 16)
    w = [torch.zeros(8, 10), torch.zeros(16, 8)]
    bias = torch.zeros(8, requires_grad=True)
    refusal = dense_level_cuda.refusal
    assert refusal(g[0], g[1], g[2], m, w, 4, torch.bfloat16, [bias]) == "grad"
    with torch.no_grad():
        assert refusal(g[0], g[1], g[2], m, w, 4, torch.bfloat16, [bias]) == "cpu"


@pytest.mark.parametrize("layer,kind", [(0, dense_level_cuda.MEAN), (1, dense_level_cuda.VAR),
                                        (1, dense_level_cuda.MAX)])
def test_dense_level_pass_opcheck(layer, kind):
    """The op's schema, fake implementation and dispatch (``torch.library.opcheck``)."""
    xyz_raw, xyz, feat, rng = level_inputs(11)
    g = [torch.from_numpy(a) for a in (xyz_raw, xyz, feat)]
    w, b, s, h = (list(x) for x in zip(*level_layers(rng, 6, (8, 16))))
    m = dense_window.window_multiplicity(
        g[1], out_h=4, out_w=8, qstride=(2, 2), kernel_size=(3, 5), K=4, distance=1.5)
    stats = [torch.rand(2, c) + 0.5 for c in (8, 8, 16, 16)][:2 * layer + (kind == 1)]
    if kind == dense_level_cuda.MAX:
        stats = [torch.rand(2, c) + 0.5 for c in (8, 8, 16, 16)]
    torch.library.opcheck(torch.ops.i2pnet.dense_level_pass.default,
                          (*g, m, w, b, s, h, stats, 64.0, 4, 8, [2, 2], [3, 5], 4,
                           "diff_feature", True, layer, kind, 1e-5))
