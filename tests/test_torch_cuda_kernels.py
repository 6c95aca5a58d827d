"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Each test needs a CUDA device and skips without one (decided inside the
fixture, never at import). The file imports no jax, so on a machine without
jax it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

The same comparisons run at the main path's shapes in ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from i2pnet_tpu_torch.ops import (conv_cuda, conv_train_cuda, cv_cuda, fps_cuda, pool_route_cuda,
                                  select_cuda)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the plain conv goes through cuDNN, whose f32 default is TF32 (~3 digits)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,N,npoint", [(2, 100, 17), (2, 1000, 1000), (3, 4096, 512), (1, 8192, 64),
                                        (1, 12000, 64)])
def test_fps_kernel_matches_plain(dev, B, N, npoint):
    rng = np.random.default_rng(N)
    xyz = torch.from_numpy(rng.normal(size=(B, N, 3)).astype(np.float32)).to(dev)
    xyz[:, N // 2] = xyz[:, 0]  # a duplicate point: a tie the argmax must break low
    before = fps_cuda.launches
    got = fps_cuda.fps_cuda(xyz, npoint)
    torch.cuda.synchronize()
    assert fps_cuda.launches == before + 1
    # exact: same arithmetic order, ties to the lowest index
    assert torch.equal(got, fps_cuda.fps_plain(xyz, npoint))


def tie_heavy_knn_inputs(case, rng):
    """(xyz (B, N, 3), queries (B, S, 3)) whose distances tie across the
    k-th place: a quantised cloud; a cloud half zero padding queried by
    itself (the large-range loaders' tail); zero queries against the
    symmetric pixel grid of a 20x40 feature map (a zero point projected)."""
    if case == "quantised":
        xyz = np.round(rng.normal(size=(8, 8192, 3)) * 2) / 4
        return xyz, xyz[:, :2048]
    if case == "zero_padded":
        xyz = rng.normal(size=(2, 8192, 3)) * 20
        xyz[:, 3000:] = 0.0
        return xyz, xyz[:, ::4]
    u, v = np.meshgrid(np.arange(40) - 19.5, np.arange(20) - 9.5)
    grid = np.stack([u / 32, v / 32, np.ones_like(u)], -1).reshape(1, -1, 3)
    queries = np.concatenate([np.zeros((2, 64, 3)), rng.normal(size=(2, 192, 3)) * 0.5], 1)
    return np.repeat(grid, 2, 0), queries


@pytest.mark.parametrize("case", ["quantised", "zero_padded", "pixel_grid"])
def test_knn_point_on_the_card_takes_ties_by_index(dev, case):
    """The card's KNN (f32 topk, its picks ordered by distance and index)
    equals the int64-key top-k over the whole row (``knn_by_key``, the
    CPU's path) on the same distances, where ties straddle the k-th place:
    lax.top_k's order, index for index."""
    from i2pnet_tpu_torch.ops import pointops

    xyz, q = (torch.from_numpy(a.astype(np.float32)).to(dev)
              for a in tie_heavy_knn_inputs(case, np.random.default_rng(7)))
    d = pointops.square_distance(q, xyz)
    srt = torch.sort(d, dim=-1).values
    for k in (1, 8, 16, 32):
        assert torch.equal(pointops.knn_point(k, xyz, q), pointops.knn_by_key(k, d)), k
    assert any(bool((srt[..., k - 1] == srt[..., k]).any()) for k in (1, 8, 16, 32))


# the four FPS levels of the free path (B, N, npoint), each at the
# launcher's thread count (0) and at 256, 512 and 1024 threads a row
FPS_LEVELS = [(8, 8192, 2048), (8, 2048, 1024), (8, 1024, 256), (8, 256, 64)]


# past the register kernel's reach: more than 16384 points (distances in
# shared memory, then, past 49152, in the wrapper's scratch) and more than
# 32 points a thread at a named thread count (B, N, npoint, threads)
FPS_ANY_CASES = [(2, 20000, 1024, 0), (2, 40000, 1024, 0), (1, 60000, 256, 0),
                 (2, 8192, 512, 128), (1, 17000, 300, 256)]


@pytest.mark.parametrize("B,N,npoint,threads", FPS_ANY_CASES)
def test_fps_any_size_matches_plain(dev, B, N, npoint, threads):
    """The any-N kernel on quantised clouds (many equal distances): the
    plain loop's indices exactly, one launch a call."""
    rng = np.random.default_rng(N + threads)
    xyz = np.round(rng.normal(size=(B, N, 3)) * 4) / 4
    xyz = torch.from_numpy(xyz.astype(np.float32)).to(dev)
    before = fps_cuda.launches
    got = fps_cuda.fps_cuda(xyz, npoint, threads)
    torch.cuda.synchronize()
    assert fps_cuda.launches == before + 1
    assert torch.equal(got, fps_cuda.fps_plain(xyz, npoint))


@pytest.mark.parametrize("threads", [0, 256, 512, 1024])
@pytest.mark.parametrize("B,N,npoint", FPS_LEVELS)
def test_fps_kernel_matches_plain_on_tied_levels(dev, B, N, npoint, threads):
    """Coordinates on a coarse grid: equal maxima at many steps, which the
    kernel must break to the lowest index as the plain loop does."""
    rng = np.random.default_rng(N + threads)
    xyz = np.round(rng.normal(size=(B, N, 3)) * 4) / 4
    xyz = torch.from_numpy(xyz.astype(np.float32)).to(dev)
    got = fps_cuda.fps_cuda(xyz, npoint, threads)
    torch.cuda.synchronize()
    assert torch.equal(got, fps_cuda.fps_plain(xyz, npoint))


CONV_CASES = [
    # B, H, W, cin, cout, stride
    (2, 16, 32, 16, 16, 1),
    (2, 16, 32, 16, 16, 2),
    (2, 16, 32, 3, 16, 2),
    (2, 16, 32, 16, 32, 2),
    (2, 8, 16, 32, 64, 1),
    (1, 8, 16, 64, 128, 2),
    (2, 12, 32, 16, 16, 1),
    (1, 37, 45, 8, 24, 2),  # ragged tiles, odd sizes, cout % 16 != 0
]


@pytest.mark.parametrize("B,H,W,cin,cout,stride", CONV_CASES)
def test_conv_block_kernel_matches_plain(dev, B, H, W, cin, cout, stride):
    rng = np.random.default_rng(cin * cout + H)
    x = torch.from_numpy(rng.normal(size=(B, H, W, cin)).astype(np.float32))
    w = torch.from_numpy(0.3 * rng.normal(size=(3, 3, cin, cout)).astype(np.float32))
    scale = torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32))
    shift = torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32))
    xb, wb = x.to(dev, torch.bfloat16), w.to(dev, torch.bfloat16)
    ref = conv_cuda.conv_block_plain(xb, wb, scale.to(dev), shift.to(dev), stride).float()
    got = conv_cuda.conv_block_cuda(xb, wb, scale.to(dev), shift.to(dev), stride).float()
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    # f32 sums in another order may flip a bf16 rounding: one bf16 ulp of
    # the magnitude, the JAX kernel's own bar (tests/test_conv_pallas.py)
    assert float((got - ref).abs().max()) <= 0.01 * max(float(ref.abs().max()), 1.0)


# the block's edges: the raw-row path (cin 3, 5) and the NHWC one (8; 12,
# whose rows are not 16-byte aligned), cout 8 to 128 (128: two channel
# tiles), sizes that fill no slab, strip or ring evenly, several slabs, a
# 1-row and a 1-column image, both strides
CONV_EDGE_CASES = [
    (2, 9, 37, 3, 8, 1),
    (2, 9, 37, 3, 24, 2),
    (1, 1, 50, 3, 16, 2),
    (1, 1, 50, 8, 16, 1),
    (2, 11, 300, 8, 16, 1),
    (2, 11, 300, 8, 16, 2),
    (1, 13, 29, 12, 24, 1),
    (1, 13, 29, 12, 16, 2),
    (1, 10, 130, 5, 32, 2),
    (2, 7, 1, 16, 8, 1),
    (2, 7, 1, 16, 8, 2),
    (1, 6, 83, 64, 128, 1),
    (1, 6, 83, 64, 128, 2),
    (2, 25, 81, 32, 64, 1),
    (1, 17, 260, 16, 16, 2),
    (2, 40, 130, 3, 16, 2),
]


@pytest.mark.parametrize("B,H,W,cin,cout,stride", CONV_EDGE_CASES)
def test_conv_block_kernel_edges(dev, B, H, W, cin, cout, stride):
    """Within one bf16 ulp of the magnitude of the plain version, one
    launch a call, every output written (the output starts as NaN)."""
    rng = np.random.default_rng(cin * cout + H * W)
    x = torch.from_numpy(rng.normal(size=(B, H, W, cin)).astype(np.float32)).to(dev, torch.bfloat16)
    w = torch.from_numpy(0.3 * rng.normal(size=(3, 3, cin, cout)).astype(np.float32)).to(dev, torch.bfloat16)
    scale = torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32)).to(dev)
    shift = torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32)).to(dev)
    # a freed NaN block for the output to reuse: an unwritten output shows
    torch.full((B * H * W * cout,), float("nan"), device=dev)
    before = conv_cuda.launches
    got = conv_cuda.conv_block_cuda(x, w, scale, shift, stride).float()
    torch.cuda.synchronize()
    assert conv_cuda.launches == before + 1
    ref = conv_cuda.conv_block_plain(x, w, scale, shift, stride).float()
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 0.01 * max(float(ref.abs().max()), 1.0)


def test_stage_off_the_kernels_runs_the_native_chain(dev):
    """cout = 12 fails the gates: the bf16 stage runs the native chain on
    the card, at eval and in training, with no kernel launched, and agrees
    with the same stage on the CPU."""
    from i2pnet_tpu_torch.nn.layers import RGBEncoderStage

    torch.manual_seed(0)
    stage = RGBEncoderStage(3, (12, 16), (2, 1), torch.bfloat16)
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(2, 16, 24, 3)).astype(np.float32))
    with torch.no_grad():
        ref = stage.eval()(x)
    stage = stage.to(dev)
    counts = (conv_cuda.launches, dict(conv_train_cuda.launches))
    with torch.no_grad():
        got = stage.eval()(x.to(dev))
    out = stage.train()(x.to(dev))
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert (conv_cuda.launches, dict(conv_train_cuda.launches)) == counts
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(out.float()).all())
    # the same bf16 chain on both devices; sums in another order
    assert float((got.float().cpu() - ref.float()).abs().max()) <= \
        0.02 * max(float(ref.float().abs().max()), 1.0)


def _cv1_operands(dev, B, N, K, C, H1, H2, H3, E, G1, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, dtype=torch.float32, s=1.0):
        return torch.from_numpy((s * rng.normal(size=shape)).astype(np.float32)).to(dev, dtype)

    bf = torch.bfloat16
    return (
        t(B, N, C, dtype=bf), t(B, N, H1), t(B, N, E), t(B, K, C, dtype=bf), t(B, K, H1), t(B, K, E),
        t(C, H1, dtype=bf, s=C**-0.5), t(H1, H2, dtype=bf, s=H1**-0.5), t(H2),
        t(H2, H3, dtype=bf, s=H2**-0.5), t(H3), t(E, G1, dtype=bf, s=E**-0.5),
        t(H3, G1, dtype=bf, s=H3**-0.5), t(G1), t(G1, H3, dtype=bf, s=G1**-0.5), t(H3),
    )


@pytest.mark.parametrize(
    "B,N,K,C,H1,H2,H3,E,G1",
    [(2, 8, 40, 32, 32, 16, 16, 16, 32), (1, 5, 480, 128, 128, 64, 64, 64, 128), (2, 3, 7, 16, 16, 16, 16, 16, 16),
     # K not a multiple of the 64-pixel tile, N = 1, the narrowest widths,
     # odd query counts over the block's two warpgroups, mixed widths
     (2, 7, 100, 128, 128, 64, 64, 64, 128), (1, 1, 480, 128, 128, 64, 64, 64, 128),
     (3, 1, 64, 16, 16, 16, 16, 16, 16), (1, 33, 130, 48, 80, 32, 48, 16, 112),
     (2, 300, 65, 128, 128, 64, 64, 64, 128)],
)
def test_cv1_kernel_matches_plain(dev, B, N, K, C, H1, H2, H3, E, G1):
    ops = _cv1_operands(dev, B, N, K, C, H1, H2, H3, E, G1)
    ref = cv_cuda.cv1_plain(*ops)
    got = cv_cuda.cv1_cuda(*ops)
    torch.cuda.synchronize()
    # f32 sums in another order flip some bf16 roundings of h1/h2/g1, and
    # the online softmax rescales: the JAX kernel's gap to native, 5e-3
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= 5e-3


def test_kernels_reject_what_they_cannot_take(dev):
    with pytest.raises(ValueError):
        fps_cuda.fps_cuda(torch.zeros(1, 8, 3, device=dev, dtype=torch.float64), 4)
    with pytest.raises(ValueError):  # 100 threads: not a multiple of 32
        fps_cuda.fps_cuda(torch.zeros(1, 8192, 3, device=dev), 4, 100)
    x = torch.zeros(1, 8, 8, 4, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # stride 3
        conv_cuda.conv_block_cuda(x, torch.zeros(3, 3, 4, 8, device=dev, dtype=torch.bfloat16),
                                  torch.ones(8, device=dev), torch.zeros(8, device=dev), 3)
    with pytest.raises(ValueError):  # 12 output channels: not a multiple of 8
        conv_cuda.conv_block_cuda(x, torch.zeros(3, 3, 4, 12, device=dev, dtype=torch.bfloat16),
                                  torch.ones(12, device=dev), torch.zeros(12, device=dev), 1)
    ops = list(_cv1_operands(dev, 1, 2, 8, 24, 16, 16, 16, 16, 16))
    with pytest.raises(ValueError):  # C = 24 is not a multiple of 16
        cv_cuda.cv1_cuda(*ops)


# the train-encoder kernels (ops/conv_train_cuda.py): B, H, W, cin, cout
TRAIN_CONV_CASES = [
    (2, 16, 32, 3, 16),    # b0: cin = 3, padded in shared memory
    (2, 16, 32, 16, 16),
    (2, 16, 32, 16, 32),
    (1, 8, 16, 64, 128),
    (1, 37, 45, 8, 24),    # ragged tiles, odd sizes, cout % 16 != 0
    (2, 24, 80, 64, 64),   # the last stage's width
    (1, 384, 1280, 3, 16),   # the first call of the free step, one batch row
    (1, 192, 640, 16, 32),
    (1, 43, 211, 16, 16),    # H not a multiple of the strip, W not of the slab
    (1, 29, 150, 5, 16),     # the raw path's widest input (8 channels a pixel)
    (1, 29, 150, 8, 16),     # the NHWC path's narrowest
    (1, 30, 70, 48, 40),     # the NHWC path's chunk loop (3 chunks), 5 n8 tiles
    (1, 12, 40, 176, 64),    # the gate's edge in the earlier layout
    (1, 20, 33, 256, 24),    # past it: the one-block-a-SM budget
    (1, 1, 1, 12, 24),       # one pixel; unaligned rows (cin = 12)
    (3, 7, 9, 24, 128),      # the channel tile halved to fill the card
]


def _bf16(dev, rng, *shape, s=1.0):
    return torch.from_numpy((s * rng.normal(size=shape)).astype(np.float32)).to(dev, torch.bfloat16)


@pytest.mark.parametrize("B,H,W,cin,cout", TRAIN_CONV_CASES)
def test_train_conv_kernels_match_plain(dev, B, H, W, cin, cout):
    """(a) forward and, with cin and cout swapped, dx; (b) dw, twice,
    bit-identical (a fixed order of sums, no atomics)."""
    ct = conv_train_cuda
    rng = np.random.default_rng(cin * cout + H)
    x = _bf16(dev, rng, B, H, W, cin)
    w = _bf16(dev, rng, cout, 3, 3, cin, s=0.3)
    b = torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32)).to(dev)
    g = _bf16(dev, rng, B, H, W, cout)
    y = ct.conv_fwd_cuda(x, w, b)
    ref = ct.conv_fwd_plain(x, w, b)
    # f32 sums in another order may flip a bf16 rounding: one bf16 ulp of
    # the magnitude, as the eval encoder block
    assert y.shape == ref.shape and y.dtype == torch.bfloat16
    assert float((y.float() - ref.float()).abs().max()) <= 0.01 * max(float(ref.float().abs().max()), 1.0)
    if cin % 8 == 0:  # dx: the conv from cout channels back to cin
        wt = w.flip(1, 2).permute(3, 1, 2, 0).contiguous()  # (cin, 3, 3, cout)
        dx, ref = ct.conv_dx_cuda(g, wt), ct.conv_dx_plain(g, wt)
        assert dx.shape == (B, H, W, cin)
        assert float((dx.float() - ref.float()).abs().max()) <= 0.01 * max(float(ref.float().abs().max()), 1.0)
    dw, dw2 = ct.conv_dw_cuda(x, g), ct.conv_dw_cuda(x, g)
    ref = ct.conv_dw_plain(x, g)
    torch.cuda.synchronize()
    assert torch.equal(dw, dw2)
    # f32 sums over B*H*W products in another order: the JAX kernel's bar
    # (tests/test_conv_pallas_train.py), 2e-3 of the largest entry
    assert float((dw - ref).abs().max()) <= 2e-3 * float(ref.abs().max())


# kernel (a)'s calls of the free train step (forward and dx)
FREE_STEP_CONV_CALLS = [
    (8, 384, 1280, 3, 16), (8, 192, 640, 16, 16), (8, 192, 640, 16, 32), (8, 192, 640, 32, 16),
    (8, 96, 320, 32, 32), (8, 48, 160, 32, 32), (8, 48, 160, 32, 64), (8, 48, 160, 64, 32),
    (8, 24, 80, 64, 64), (8, 24, 80, 64, 128), (8, 24, 80, 128, 64),
]


# kernel (a) on plans other than the default one (co_t, mt, rows):
# channel tiles and slab widths of its forms, one iteration a strip and many
CONV_PLAN_CASES = [
    ((2, 50, 300, 3, 16), (16, 8, 4)), ((2, 50, 300, 3, 16), (8, 3, 12)),
    ((1, 40, 200, 16, 32), (32, 8, 8)), ((1, 40, 200, 16, 32), (16, 2, 40)),
    ((1, 24, 80, 64, 64), (64, 1, 4)), ((1, 24, 80, 64, 64), (16, 5, 24)),
    ((1, 9, 70, 5, 8), (8, 5, 4)), ((1, 30, 70, 48, 40), (40, 3, 28)),
]


@pytest.mark.parametrize("shape,plan", CONV_PLAN_CASES)
def test_conv_kernel_on_other_plans(dev, shape, plan):
    """conv3x3_launch_plan on a plan the shape does not pick by default,
    within the same bar as the default plan."""
    ct = conv_train_cuda
    B, H, W, cin, cout = shape
    co_t, mt, rows = plan
    rng = np.random.default_rng(cin + cout + mt)
    x = _bf16(dev, rng, B, H, W, cin)
    w = _bf16(dev, rng, cout, 3, 3, cin, s=0.3)
    b = torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32)).to(dev)
    y = torch.empty(B, H, W, cout, dtype=torch.bfloat16, device=dev)
    sw = min(W, 16 * mt)
    lib = ct._conv_lib()
    code = lib.conv3x3_launch_plan(
        ct._build.ptr(x), ct._build.ptr(w), ct._build.ptr(b), ct._build.ptr(y), B, H, W, cin, cout,
        co_t, mt, sw, -(-W // sw), rows, -(-H // rows), ct._build.stream_of(x))
    ct._build.check(lib, code, "conv3x3_launch_plan")
    ref = ct.conv_fwd_plain(x, w, b)
    torch.cuda.synchronize()
    assert float((y.float() - ref.float()).abs().max()) <= 0.01 * max(float(ref.float().abs().max()), 1.0)


@pytest.mark.parametrize("B,H,W,cin,cout", TRAIN_CONV_CASES + FREE_STEP_CONV_CALLS)
def test_conv_plan_mirror_matches_the_card(dev, B, H, W, cin, cout):
    """``_conv_plan`` (the mirror the CPU tests check) is the plan the
    launcher takes, on this card's SM count."""
    ct = conv_train_cuda
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert ct.conv_plan_on_card(B, H, W, cin, cout) == ct._conv_plan(B, H, W, cin, cout, sms)


# (b) at the shapes of the free train step: the encoder's seven (cin, cout)
# pairs, 3 -> 16 at the full image; ragged tiles with cout % 16 != 0; the
# raw-row path at cin = 5 over two slabs; unaligned rows (cin = 6)
DW_ENCODER_CASES = [
    (8, 384, 1280, 3, 16),
    (8, 192, 640, 16, 16),
    (8, 192, 640, 16, 32),
    (8, 96, 320, 32, 32),
    (8, 48, 160, 32, 64),
    (8, 24, 80, 64, 64),
    (8, 24, 80, 64, 128),
    (1, 37, 45, 8, 24),
    (1, 13, 150, 5, 16),
    (1, 11, 40, 6, 8),
]


@pytest.mark.parametrize("B,H,W,cin,cout", DW_ENCODER_CASES)
def test_conv_dw_kernel_at_encoder_shapes(dev, B, H, W, cin, cout):
    """Within 2e-3 x max of the plain version, bit-identical on a repeat,
    one launch a call, and the arrival counters left zero."""
    ct = conv_train_cuda
    rng = np.random.default_rng(cin * cout + H)
    x = _bf16(dev, rng, B, H, W, cin)
    g = _bf16(dev, rng, B, H, W, cout)
    before = ct.launches["conv_dw"]
    dw, dw2 = ct.conv_dw_cuda(x, g), ct.conv_dw_cuda(x, g)
    torch.cuda.synchronize()
    assert ct.launches["conv_dw"] == before + 2
    assert not bool(ct._dw_counter_buffer(x.device).any())
    assert torch.equal(dw, dw2)
    ref = ct.conv_dw_plain(x, g)
    assert float((dw - ref).abs().max()) <= 2e-3 * float(ref.abs().max())


BN_POOL_CASES = [
    # B, H, W, C, stride, ties
    (2, 16, 32, 8, 1, False),
    (2, 16, 32, 8, 2, True),
    (2, 16, 32, 16, 1, True),
    (1, 7, 9, 8, 2, False),    # odd sizes: the pad never wins
    (1, 7, 9, 24, 1, True),
    (1, 24, 80, 128, 2, False),
    (1, 384, 1280, 16, 2, False),  # the first call of the free step, one batch row
    (1, 192, 640, 32, 2, True),
    (1, 33, 71, 40, 1, True),      # odd sizes, 5 channel groups
    (1, 33, 71, 40, 2, True),
    (2, 50, 130, 64, 1, False),
    (1, 24, 80, 128, 1, True),
    (1, 17, 1, 8, 2, True),        # one column
    (1, 1, 19, 24, 1, False),      # one row
    (1, 35, 67, 48, 2, True),      # 6 groups, tiles ragged both ways
]


@pytest.mark.parametrize("B,H,W,C,stride,ties", BN_POOL_CASES)
def test_bn_pool_kernels_match_plain(dev, B, H, W, C, stride, ties):
    """(c) out and taps, and (d) dz, bit for bit: compares of the same
    bf16-rounded values, the affine rounded twice on both sides, dz summed
    in tap order on both sides."""
    ct = conv_train_cuda
    rng = np.random.default_rng(C * H + stride)
    y = rng.normal(size=(B, H, W, C))
    if ties:
        y = np.round(y * 2) / 2
    y = torch.from_numpy(y.astype(np.float32)).to(dev, torch.bfloat16)
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)).to(dev)
    sh = torch.from_numpy((0.1 * rng.normal(size=C)).astype(np.float32)).to(dev)
    out, taps = ct.bn_pool_fwd_cuda(y, sc, sh, stride)
    out_ref, taps_ref = ct.bn_pool_fwd_plain(y, sc, sh, stride)
    assert torch.equal(out, out_ref) and torch.equal(taps, taps_ref)
    g = _bf16(dev, rng, *out.shape)
    dz = ct.bn_pool_bwd_cuda(y, sc, sh, taps, g, stride)
    torch.cuda.synchronize()
    assert torch.equal(dz, ct.bn_pool_bwd_plain(y, sc, sh, taps, g, stride))
    # the cotangent routed by other taps (each tap equally likely): every
    # path of the tap order, not only those the forward's maxima take
    taps2 = torch.from_numpy(rng.integers(0, 9, size=taps.shape).astype(np.uint8)).to(dev)
    dz2 = ct.bn_pool_bwd_cuda(y, sc, sh, taps2, g, stride)
    torch.cuda.synchronize()
    assert torch.equal(dz2, ct.bn_pool_bwd_plain(y, sc, sh, taps2, g, stride))


# B, H, W, C, stride, kind: the forward's tiles (16 x 64 / CG pooled cells
# at stride 2, 32 x 64 / CG at stride 1) ragged both ways; H or W of 1-3 at
# both strides; C = 8, 16, 24, 32, 40, 64 and 384 (CG 1, 2, 4 and 8; 384: 6
# chunks of 8 groups); "ties": inputs on a half-unit grid; "halo": y < 0
# everywhere and sh = 3, so a zero-filled halo (bf16(LeakyReLU(sh)) = 3)
# would beat every pixel at the image's edges
POOL_FWD_EDGE_CASES = [
    (1, 1, 1, 8, 1, "ties"),
    (1, 1, 1, 8, 2, "halo"),
    (2, 2, 3, 24, 1, "halo"),
    (2, 3, 2, 40, 2, "ties"),
    (1, 3, 70, 16, 1, "halo"),
    (1, 70, 3, 16, 2, "halo"),
    (1, 2, 131, 384, 2, "ties"),
    (1, 33, 65, 8, 2, "ties"),
    (1, 33, 65, 8, 1, "halo"),
    (1, 65, 129, 16, 1, "ties"),
    (2, 37, 19, 24, 2, "halo"),
    (1, 45, 30, 40, 1, "ties"),
    (1, 34, 20, 64, 2, "halo"),
    (1, 17, 23, 384, 1, "halo"),
    (1, 18, 11, 384, 2, "ties"),
    (2, 31, 63, 32, 2, "normal"),
]


@pytest.mark.parametrize("B,H,W,C,stride,kind", POOL_FWD_EDGE_CASES)
def test_bn_pool_fwd_kernels_edges(dev, B, H, W, C, stride, kind):
    """(c) out and taps and (e) out bit for bit against their plain versions
    where the tile is ragged, the image tiny, every channel tiling, ties,
    and an sh under which an unmasked halo would win."""
    ct = conv_train_cuda
    rng = np.random.default_rng(B * H * W + C + stride)
    y = rng.normal(size=(B, H, W, C))
    sc = rng.uniform(0.5, 1.5, C)
    sh = 0.1 * rng.normal(size=C)
    if kind == "ties":
        y = np.round(y * 2) / 2
    elif kind == "halo":
        y, sh = -np.abs(y) - 0.25, np.full(C, 3.0)
    y = torch.from_numpy(y.astype(np.float32)).to(dev, torch.bfloat16)
    sc = torch.from_numpy(sc.astype(np.float32)).to(dev)
    sh = torch.from_numpy(sh.astype(np.float32)).to(dev)
    before = dict(ct.launches)
    out, taps = ct.bn_pool_fwd_cuda(y, sc, sh, stride)
    notap = ct.bn_pool_fwd_notap_cuda(y, sc, sh, stride)
    torch.cuda.synchronize()
    assert ct.launches["bn_pool_fwd"] == before["bn_pool_fwd"] + 1
    assert ct.launches["bn_pool_fwd_notap"] == before["bn_pool_fwd_notap"] + 1
    out_ref, taps_ref = ct.bn_pool_fwd_plain(y, sc, sh, stride)
    assert out.shape == (B, (H - 1) // stride + 1, (W - 1) // stride + 1, C)
    assert torch.equal(out, out_ref) and torch.equal(taps, taps_ref)
    assert torch.equal(notap, ct.bn_pool_fwd_notap_plain(y, sc, sh, stride))
    assert torch.equal(notap, out)
    if kind == "halo":  # every maximum below 3: no halo cell won
        assert float(out.float().max()) < 3.0


# B, H, W, C, stride, ties: both strides, ties, ragged 8x8 tiles (H or W
# not a multiple of 8, odd sizes), the widths 8-128
RECOMPUTE_CASES = [
    (2, 16, 32, 16, 1, True),
    (2, 16, 32, 16, 2, True),
    (1, 13, 21, 32, 1, False),
    (1, 13, 21, 32, 2, True),
    (2, 10, 32, 64, 2, False),
    (1, 5, 16, 128, 1, True),
    (1, 10, 32, 128, 2, False),
    (1, 7, 9, 24, 2, True),
    (3, 9, 17, 8, 1, False),
]


@pytest.mark.parametrize("B,H,W,C,stride,ties", RECOMPUTE_CASES)
def test_bn_pool_notap_and_recompute_kernels_match_plain(dev, B, H, W, C, stride, ties):
    """(e) out and (f) dz bit for bit against their plain versions, and
    against (c)'s out and (d)'s dz with (c)'s taps: the same bf16 values
    scanned in the same order, dz summed in tap order."""
    ct = conv_train_cuda
    rng = np.random.default_rng(C * H + stride)
    y = rng.normal(size=(B, H, W, C))
    if ties:
        y = np.round(y * 2) / 2
    y = torch.from_numpy(y.astype(np.float32)).to(dev, torch.bfloat16)
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)).to(dev)
    sh = torch.from_numpy((0.1 * rng.normal(size=C)).astype(np.float32)).to(dev)
    before = dict(ct.launches)
    out = ct.bn_pool_fwd_notap_cuda(y, sc, sh, stride)
    assert torch.equal(out, ct.bn_pool_fwd_notap_plain(y, sc, sh, stride))
    out_idx, taps = ct.bn_pool_fwd_cuda(y, sc, sh, stride)
    assert torch.equal(out, out_idx)
    g = _bf16(dev, rng, *out.shape)
    dz = ct.bn_pool_bwd_recompute_cuda(y, sc, sh, g, stride)
    torch.cuda.synchronize()
    assert torch.equal(dz, ct.bn_pool_bwd_recompute_plain(y, sc, sh, g, stride))
    assert torch.equal(dz, ct.bn_pool_bwd_cuda(y, sc, sh, taps, g, stride))
    assert ct.launches["bn_pool_fwd_notap"] == before["bn_pool_fwd_notap"] + 1
    assert ct.launches["bn_pool_bwd_recompute"] == before["bn_pool_bwd_recompute"] + 1


# B, H, W, C, stride, kind: kernel (f)'s tiles (rows x 64 / CG pixels a
# parity pass, 16 rows at stride 1 and 8 at stride 2, halved while the grid
# would not fill the card) ragged both ways; H or W of 1-3 at both strides;
# C = 8, 16, 24, 32, 40, 64 and 384 (CG 1, 2, 4 and 8; 384: 6 chunks of 8
# groups); "ties": inputs on a half-unit grid; "halo": y < 0 and sh = 3, so
# that a zero-filled halo (bf16(LeakyReLU(sh)) = 3) would win every edge
# window; "zeros": y of +-0 and +-2**-133 with sc = 2**-16 and sh = -0.0,
# so z is +-0 or the smallest f32 subnormal, every a is +-0, and only z
# gives the slope (z = -0: 1; z = -2**-149: 0.1); the first free-step call;
# a batch of 65535 tiny images (the old launch's limit)
RECOMPUTE_EDGE_CASES = [
    (1, 1, 1, 8, 1, "zeros"),
    (1, 1, 1, 8, 2, "halo"),
    (2, 2, 3, 24, 1, "halo"),
    (2, 3, 2, 40, 2, "ties"),
    (1, 3, 70, 16, 1, "halo"),
    (1, 70, 3, 16, 2, "halo"),
    (1, 2, 131, 384, 2, "ties"),
    (1, 33, 65, 8, 2, "zeros"),
    (1, 33, 65, 8, 1, "halo"),
    (1, 65, 129, 16, 1, "ties"),
    (2, 37, 19, 24, 2, "zeros"),
    (1, 45, 30, 32, 1, "ties"),
    (1, 34, 20, 64, 2, "halo"),
    (1, 17, 23, 384, 1, "zeros"),
    (1, 18, 11, 384, 2, "ties"),
    (2, 31, 63, 32, 2, "normal"),
    (8, 190, 630, 16, 1, "zeros"),
    (8, 190, 630, 16, 2, "halo"),
    (8, 384, 1280, 16, 2, "normal"),
    (65535, 2, 3, 8, 1, "normal"),
]

TINY = 2.0 ** -133  # the smallest bf16 subnormal


def _pool_operands(dev, rng, B, H, W, C, kind):
    """y bf16, sc and sh f32 of one edge case's kind."""
    sc = rng.uniform(0.5, 1.5, C)
    sh = 0.1 * rng.normal(size=C)
    if kind == "zeros":
        y = np.array([0.0, -0.0, -TINY, TINY])[rng.integers(0, 4, size=(B, H, W, C))]
        sc, sh = np.full(C, 2.0 ** -16), np.full(C, -0.0)
    else:
        y = rng.normal(size=(B, H, W, C))
    if kind == "ties":
        y = np.round(y * 2) / 2
    elif kind == "halo":
        y, sh = -np.abs(y) - 0.25, np.full(C, 3.0)
    y = torch.from_numpy(y.astype(np.float32)).to(dev, torch.bfloat16)
    return (y, torch.from_numpy(sc.astype(np.float32)).to(dev),
            torch.from_numpy(sh.astype(np.float32)).to(dev))


@pytest.mark.parametrize("B,H,W,C,stride,kind", RECOMPUTE_EDGE_CASES)
def test_bn_pool_recompute_kernel_edges(dev, B, H, W, C, stride, kind):
    """(f) dz bit for bit against its plain version and against (d)'s dz on
    (c)'s taps where the tile is ragged, the image tiny, every channel
    tiling, ties, an sh under which an unmasked halo would win, and signed
    zeros and subnormals where a cannot give the slope."""
    ct = conv_train_cuda
    rng = np.random.default_rng(B * H * W + C + stride)
    y, sc, sh = _pool_operands(dev, rng, B, H, W, C, kind)
    g = _bf16(dev, rng, B, (H - 1) // stride + 1, (W - 1) // stride + 1, C)
    before = ct.launches["bn_pool_bwd_recompute"]
    dz = ct.bn_pool_bwd_recompute_cuda(y, sc, sh, g, stride)
    torch.cuda.synchronize()
    assert ct.launches["bn_pool_bwd_recompute"] == before + 1
    assert torch.equal(dz, ct.bn_pool_bwd_recompute_plain(y, sc, sh, g, stride))
    _, taps = ct.bn_pool_fwd_cuda(y, sc, sh, stride)
    assert torch.equal(dz, ct.bn_pool_bwd_cuda(y, sc, sh, taps, g, stride))


def test_bn_pool_recompute_slope_comes_from_z(dev):
    """The slope trap: on the "zeros" inputs every a is +-0, so dz's slope
    at a routed pixel is 1 where z = -0 and 0.1 where z = -2**-149; both
    occur, and (f) gives each its own, bit for bit."""
    ct = conv_train_cuda
    rng = np.random.default_rng(9)
    y, sc, sh = _pool_operands(dev, rng, 2, 40, 72, 16, "zeros")
    g = torch.ones(2, 20, 36, 16, device=dev, dtype=torch.bfloat16)
    dz = ct.bn_pool_bwd_recompute_cuda(y, sc, sh, g, 2)
    torch.cuda.synchronize()
    assert torch.equal(dz, ct.bn_pool_bwd_recompute_plain(y, sc, sh, g, 2))
    neg_zero = (y == 0) & torch.signbit(y)
    assert bool((dz[neg_zero] >= 1).any())  # slope 1 at z = -0
    assert bool(((dz[y < 0] > 0) & (dz[y < 0] < 1)).any())  # 0.1 at z < 0


# B, Ho, Wo, C, stride, ties
ROUTE_CASES = [
    (2, 8, 16, 16, 1, True),
    (2, 8, 16, 16, 2, True),
    (1, 5, 7, 32, 1, False),
    (1, 5, 7, 32, 2, True),
    (2, 10, 32, 64, 1, False),
    (1, 5, 16, 128, 2, False),
    (1, 3, 5, 3, 2, True),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Ho,Wo,C,stride,ties", ROUTE_CASES)
def test_pool_route_kernel_matches_plain(dev, B, Ho, Wo, C, stride, ties, dtype):
    """Bit for bit: the routed terms added in tap order in ct's dtype on
    both sides; argtap from the pool of a (tied) input, some cells 9."""
    rng = np.random.default_rng(C + Ho + stride)
    x = rng.normal(size=(B, Ho * stride, Wo * stride, C))
    if ties:
        x = np.round(x * 2) / 2
    x = torch.from_numpy(x.astype(np.float32)).to(dev, dtype)
    y = torch.nn.functional.max_pool2d(x.float().permute(0, 3, 1, 2), 3, stride, 1)
    y = y.permute(0, 2, 3, 1).to(dtype)
    argtap = pool_route_cuda.pool3_argtap(x, y, stride)
    argtap[:, 0] = 9
    ct_ = torch.from_numpy(rng.normal(size=(B, Ho, Wo, C)).astype(np.float32)).to(dev, dtype)
    key = f"pool_route_s{stride}"
    before = pool_route_cuda.launches[key]
    dx = pool_route_cuda.pool_route_cuda(argtap.contiguous(), ct_, stride)
    torch.cuda.synchronize()
    assert pool_route_cuda.launches[key] == before + 1
    assert dx.dtype == dtype and dx.shape == x.shape
    assert torch.equal(dx, pool_route_cuda.pool_route_plain(argtap, ct_, stride))


# B, Ho, Wo, C, stride: the route's tiles (16 rows x 64 / CG pixels a
# parity pass, halved while the grid would not fill the card) ragged both
# ways; 1x1 images; C = 3 and 12 (the 1- and 4-channel instances), 8, 16,
# 24, 32, 64 and 384 (CG 1, 2, 4 and 8; 384: 6 chunks); 16-row passes at
# stride 1; the first free-step call; a batch of 100000 1x1 images
ROUTE_EDGE_CASES = [
    (1, 1, 1, 3, 1),
    (1, 1, 1, 12, 2),
    (2, 5, 7, 3, 2),
    (1, 9, 70, 12, 1),
    (2, 19, 33, 12, 2),
    (1, 17, 67, 8, 1),
    (1, 17, 67, 8, 2),
    (2, 33, 9, 24, 2),
    (1, 20, 33, 32, 1),
    (1, 11, 21, 64, 2),
    (1, 3, 5, 384, 1),
    (1, 6, 9, 384, 2),
    (8, 190, 630, 16, 1),
    (8, 192, 640, 16, 2),
    (100000, 1, 1, 8, 1),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Ho,Wo,C,stride", ROUTE_EDGE_CASES)
def test_pool_route_kernel_edges(dev, B, Ho, Wo, C, stride, dtype):
    """dx bit for bit against the plain version where the tile is ragged,
    the image tiny, every channel tiling and the narrow instances; argtap
    from the pool of a tied input, 9 on the first cell row and the last
    cell column."""
    rng = np.random.default_rng(B + Ho * Wo + C + stride)
    x = np.round(rng.normal(size=(B, Ho * stride, Wo * stride, C)) * 2) / 2
    x = torch.from_numpy(x.astype(np.float32)).to(dev, dtype)
    y = torch.nn.functional.max_pool2d(x.float().permute(0, 3, 1, 2), 3, stride, 1)
    argtap = pool_route_cuda.pool3_argtap(x, y.permute(0, 2, 3, 1).to(dtype), stride)
    argtap[:, 0] = 9
    argtap[:, :, -1] = 9
    ct_ = torch.from_numpy(rng.normal(size=(B, Ho, Wo, C)).astype(np.float32)).to(dev, dtype)
    dx = pool_route_cuda.pool_route_cuda(argtap, ct_, stride)
    torch.cuda.synchronize()
    assert torch.equal(dx, pool_route_cuda.pool_route_plain(argtap, ct_, stride))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pool_route_kernel_on_unaligned_operands(dev, dtype):
    """Contiguous operands that start one element past an allocation (no
    16-byte vector fits them): the launch takes the narrow instance, bit
    for bit against the plain version."""
    rng = np.random.default_rng(11)
    B, Ho, Wo, C, n = 2, 9, 13, 16, 2 * 9 * 13 * 16
    at_flat = torch.from_numpy(rng.integers(0, 10, size=n + 1).astype(np.uint8)).to(dev)
    ct_flat = torch.from_numpy(rng.normal(size=n + 1).astype(np.float32)).to(dev, dtype)
    argtap, ct_ = at_flat[1:].view(B, Ho, Wo, C), ct_flat[1:].view(B, Ho, Wo, C)
    for stride in (1, 2):
        dx = pool_route_cuda.pool_route_cuda(argtap, ct_, stride)
        torch.cuda.synchronize()
        assert torch.equal(dx, pool_route_cuda.pool_route_plain(argtap, ct_, stride))


def test_pool_kernels_reject_what_they_cannot_take(dev):
    at = torch.zeros(1, 4, 4, 8, device=dev, dtype=torch.uint8)
    with pytest.raises(ValueError):  # stride 3
        pool_route_cuda.pool_route_cuda(at, torch.zeros(1, 4, 4, 8, device=dev), 3)
    with pytest.raises(ValueError):  # f16 cotangent
        pool_route_cuda.pool_route_cuda(at, torch.zeros(1, 4, 4, 8, device=dev, dtype=torch.float16), 1)
    with pytest.raises(ValueError):  # int32 argtap
        pool_route_cuda.pool_route_cuda(at.int(), torch.zeros(1, 4, 4, 8, device=dev), 1)
    y = torch.zeros(1, 8, 8, 12, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # 12 channels: not a multiple of 8
        conv_train_cuda.bn_pool_fwd_notap_cuda(y, torch.ones(12, device=dev),
                                               torch.zeros(12, device=dev), 1)
    y = torch.zeros(1, 8, 8, 16, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # a cotangent of the wrong shape
        conv_train_cuda.bn_pool_bwd_recompute_cuda(y, torch.ones(16, device=dev),
                                                   torch.zeros(16, device=dev), y, 2)


def test_train_kernels_reject_what_they_cannot_take(dev):
    ct = conv_train_cuda
    bf = torch.bfloat16
    x = torch.zeros(1, 8, 8, 16, device=dev, dtype=bf)
    with pytest.raises(ValueError):  # 12 output channels: not a multiple of 8
        ct.conv_fwd_cuda(x, torch.zeros(12, 3, 3, 16, device=dev, dtype=bf), torch.zeros(12, device=dev))
    with pytest.raises(ValueError):  # f32 input
        ct.conv_fwd_cuda(x.float(), torch.zeros(16, 3, 3, 16, device=dev, dtype=bf), None)
    with pytest.raises(ValueError):  # a CPU tensor
        ct.conv_dw_cuda(x.cpu(), x.cpu())
    with pytest.raises(ValueError):  # stride 3
        ct.bn_pool_fwd_cuda(x, torch.ones(16, device=dev), torch.zeros(16, device=dev), 3)
    y = torch.zeros(1, 8, 8, 12, device=dev, dtype=bf)
    with pytest.raises(ValueError):  # 12 channels: not a multiple of 8
        ct.bn_pool_fwd_cuda(y, torch.ones(12, device=dev), torch.zeros(12, device=dev), 1)
    taps = torch.zeros(1, 4, 4, 16, device=dev, dtype=torch.uint8)
    with pytest.raises(ValueError):  # a cotangent of the wrong shape
        ct.bn_pool_bwd_cuda(x, torch.ones(16, device=dev), torch.zeros(16, device=dev), taps,
                            torch.zeros(1, 8, 8, 16, device=dev, dtype=bf), 2)


def _range_grid(rng, B, h2, w2, holes=0.3):
    """A range image as the projection gives one: a cylinder of radius 10
    (neighbouring cells 0.035 apart across, 0.05 down) with a little noise,
    quantised so that equal distances abound, and empty cells."""
    az = np.linspace(0, 2 * np.pi, w2, endpoint=False)[None, :]
    z = 0.05 * np.arange(h2)[:, None] + 0 * az
    xyz = np.stack([10 * np.cos(az) + 0 * z, 10 * np.sin(az) + 0 * z, z], -1)
    xyz = xyz[None] + 0.01 * rng.normal(size=(B, h2, w2, 3))
    xyz = np.round(xyz * 64) / 64
    xyz[rng.random((B, h2, w2)) < holes] = 0.0
    return xyz.astype(np.float32)


# B, (h2, w2), (out_h, out_w), qstride, kernel, K, distance: the four cases
# of tests/test_dense_window.py, then the first level of the shipped proj
# config (64x1800 -> 16x225) on a range-image-like grid and on a random one
SELECT_CASES = [
    (2, (8, 16), (4, 8), (2, 2), (3, 5), 4, 1.5),
    (2, (8, 16), (8, 16), (1, 1), (3, 3), 4, 1.0),
    (2, (8, 16), (2, 4), (4, 4), (5, 5), 8, 2.0),
    (2, (8, 16), (4, 8), (2, 2), (3, 3), 16, 1.5),  # K > khw: sentinel / copy fill
    (2, (64, 1800), (16, 225), (4, 8), (9, 15), 32, 0.75),
    (1, (64, 1800), (16, 225), (4, 8), (9, 15), 32, 60.0),
    # more than 255 slots: the shared-memory path (289 slots and the sentinel)
    (2, (40, 64), (10, 16), (4, 4), (17, 17), 32, 1.5),
    (1, (64, 1800), (16, 225), (4, 8), (17, 17), 64, 0.75),
    (1, (24, 40), (6, 10), (4, 4), (21, 33), 300, 60.0),
]


@pytest.mark.parametrize("B,grid,out_hw,qstride,kernel,K,distance", SELECT_CASES)
def test_select_kernel_matches_plain(dev, B, grid, out_hw, qstride, kernel, K, distance):
    """Exact: the same distances without FMAs, ties to the lowest slot."""
    rng = np.random.default_rng(grid[1] + K)
    if grid[1] > 100:
        xyz = _range_grid(rng, B, *grid) if distance < 10 else \
            np.round(rng.normal(size=(B, *grid, 3)) * 40).astype(np.float32)
    else:
        xyz = rng.normal(size=(B, *grid, 3)).astype(np.float32)
        xyz[rng.random((B, *grid)) < 0.3] = 0.0
        xyz = np.round(xyz * 4) / 4
    xyz = torch.from_numpy(xyz).to(dev)
    before = select_cuda.launches
    got = select_cuda.selection_multiplicity_cuda(xyz, *out_hw, qstride, kernel, K, distance)
    torch.cuda.synchronize()
    assert select_cuda.launches == before + 1
    ref = select_cuda.selection_multiplicity_plain(xyz, *out_hw, qstride, kernel, K, distance)
    assert got.shape == (B, out_hw[0] * out_hw[1], kernel[0] * kernel[1] + 1)
    assert torch.equal(got, ref)
    assert bool((got.sum(-1) == K).all())
    hits = (got[..., :-1] > 0).sum(-1)
    assert int(hits.max()) > 1  # some queries found several neighbours


# the four PointNet levels of the shipped proj config at B=8 (the fifth
# call repeats the fourth's shape): grid, queries, stride, window, K, radius
SELECT_LEVELS = [
    ((64, 1800), (16, 225), (4, 8), (9, 15), 32, 0.75),
    ((16, 225), (8, 113), (2, 2), (9, 15), 16, 3.0),
    ((8, 113), (4, 57), (2, 2), (5, 9), 16, 6.0),
    ((4, 57), (4, 29), (1, 2), (5, 9), 16, 12.0),
]


def _select_grid(rng, kind, B, h2, w2):
    """Grids that reach each branch of the select kernel: "cluster", every
    point within 0.05 of (1, 1, 1), so every slot is valid; "same", one
    point everywhere, so every distance ties (at the 1e-10 floor); "steps",
    points on a coarse grid, so distances tie across lanes and registers;
    "zero_centres", every 4th row's and column's points zero: the centres
    of the even query rows at a (2, 4) query stride; "wrap", points on a
    circle along the row, so the wrapped columns' neighbours are near."""
    if kind == "cluster":
        xyz = 1.0 + 0.05 * rng.random((B, h2, w2, 3))
    elif kind == "same":
        xyz = np.ones((B, h2, w2, 3))
    elif kind == "steps":
        xyz = np.round(rng.normal(size=(B, h2, w2, 3)) * 2) / 2
        xyz[rng.random((B, h2, w2)) < 0.2] = 0.0
    elif kind == "zero_centres":
        xyz = 1.0 + 0.05 * rng.random((B, h2, w2, 3))
        xyz[:, ::4, ::4] = 0.0
    else:  # wrap
        az = np.linspace(0, 2 * np.pi, w2, endpoint=False)
        z = 0.01 * np.arange(h2)[:, None]
        xyz = np.stack(np.broadcast_arrays(np.cos(az), np.sin(az), z), -1)
        xyz = np.broadcast_to(xyz, (B, h2, w2, 3)) + 0.001 * rng.normal(size=(B, h2, w2, 3))
    return torch.from_numpy(np.ascontiguousarray(xyz, dtype=np.float32))


# kind, B, grid, out_hw, qstride, kernel, K, distance
SELECT_EDGE_CASES = [
    ("cluster", 2, (16, 40), (8, 20), (2, 2), (9, 15), 200, 1.0),  # all valid, K > 135
    ("cluster", 2, (16, 40), (8, 20), (2, 2), (9, 15), 135, 1.0),  # all valid, K = the count
    ("cluster", 2, (16, 40), (8, 20), (2, 2), (9, 15), 32, 1.0),   # all valid, K below
    ("cluster", 2, (8, 40), (4, 20), (2, 2), (5, 9), 7, 1.0),
    ("cluster", 1, (16, 40), (8, 20), (2, 2), (9, 15), 16, 1e-6),  # radius^2 < 1e-10: none
    ("zero_centres", 2, (16, 40), (8, 10), (2, 4), (9, 15), 32, 1.0),  # invalid centres
    ("same", 2, (16, 40), (8, 20), (2, 2), (9, 15), 32, 1.0),  # every distance equal
    ("same", 1, (8, 40), (4, 20), (2, 2), (5, 9), 44, 1.0),
    ("steps", 2, (16, 64), (8, 32), (2, 2), (9, 15), 16, 2.0),  # ties across lanes, registers
    ("steps", 2, (16, 64), (8, 32), (2, 2), (5, 9), 8, 3.0),
    ("wrap", 2, (8, 40), (8, 40), (1, 1), (3, 15), 12, 0.5),   # columns wrap at both edges
    ("wrap", 1, (8, 33), (4, 17), (2, 2), (5, 9), 16, 0.7),
]


@pytest.mark.parametrize("kind,B,grid,out_hw,qstride,kernel,K,distance", SELECT_EDGE_CASES)
def test_select_kernel_edges(dev, kind, B, grid, out_hw, qstride, kernel, K, distance):
    """m exactly as the plain version where every slot is valid (K above,
    at and below the count), none is, the centre is invalid, distances tie
    across lanes and registers, and the window wraps at both edges."""
    xyz = _select_grid(np.random.default_rng(K + grid[1]), kind, B, *grid).to(dev)
    got = select_cuda.selection_multiplicity_cuda(xyz, *out_hw, qstride, kernel, K, distance)
    ref = select_cuda.selection_multiplicity_plain(xyz, *out_hw, qstride, kernel, K, distance)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    S = kernel[0] * kernel[1]
    assert bool((got.sum(-1) == K).all())
    m = got.reshape(B, *out_hw, S + 1)
    if distance < 1e-5:  # no valid slot: the sentinel takes the K copies
        assert bool((m[..., S] == K).all())
    if kind == "zero_centres":  # so it does at the invalid centres, and only there
        assert bool((m[:, ::2, :, S] == K).all()) and not bool((m[:, 1::2, :, S] > 0).any())
    if kind == "wrap":  # the wrapped slots were selected at the first and last columns
        assert int((m[:, :, 0, :S] > 0).sum()) > 0 and int((m[:, :, -1, :S] > 0).sum()) > 0


@pytest.mark.parametrize("level", range(len(SELECT_LEVELS)))
@pytest.mark.parametrize("kind", ["range", "cluster"])
def test_select_kernel_at_the_proj_levels(dev, level, kind):
    """Each PointNet level's call at B=8, on a range-image-like grid (a few
    neighbours a query) and a clustered one (every slot valid, K below the
    count: the radix select), exactly as the plain version."""
    grid, out_hw, qstride, kernel, K, distance = SELECT_LEVELS[level]
    rng = np.random.default_rng(level)
    if kind == "range":
        xyz = torch.from_numpy(_range_grid(rng, 8, *grid))
    else:
        xyz = _select_grid(rng, "cluster", 8, *grid)
    xyz = xyz.to(dev)
    got = select_cuda.selection_multiplicity_cuda(xyz, *out_hw, qstride, kernel, K, distance)
    ref = select_cuda.selection_multiplicity_plain(xyz, *out_hw, qstride, kernel, K, distance)
    torch.cuda.synchronize()
    assert got.shape == (8, out_hw[0] * out_hw[1], kernel[0] * kernel[1] + 1)
    assert torch.equal(got, ref)


def test_select_kernel_rejects_what_it_cannot_take(dev):
    with pytest.raises(ValueError):  # four channels
        select_cuda.selection_multiplicity_cuda(torch.zeros(1, 8, 8, 4, device=dev), 4, 4, (2, 2),
                                                (3, 3), 4, 1.0)
    with pytest.raises(ValueError):  # 250 x 250 slots: more than a block's shared memory holds
        select_cuda.selection_multiplicity_cuda(torch.zeros(1, 8, 8, 3, device=dev), 4, 4, (2, 2),
                                                (250, 250), 4, 1.0)
    with pytest.raises(ValueError):  # a CPU tensor
        select_cuda.selection_multiplicity_cuda(torch.zeros(1, 8, 8, 3), 4, 4, (2, 2), (3, 3), 4, 1.0)


def _encoder_calls(cfg, H, W):
    """(H, W, cin, cout, stride) of each encoder-block call of a forward."""
    calls = []
    for cin, couts, strides in cfg.rgb_encoder_channels:
        for cout, stride in zip(couts, strides):
            calls.append((H, W, cin, cout, stride))
            cin, H, W = cout, -(-H // stride), -(-W // stride)
    return calls


def _b1_cases():
    """The kernels' calls of one B=1 forward at the bench shapes (the demo
    renderers' frames): FPS at the free path's four levels, the encoder
    block's 15 calls of each family, cv1 with N=256 and K=480, and the
    window select at the proj path's levels."""
    from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig

    cases = [("fps", (8192, 2048)), ("fps", (2048, 1024)), ("fps", (1024, 256)), ("fps", (256, 64))]
    cases += [("block", c) for c in _encoder_calls(I2PNetConfig(), 384, 1280)]
    cases += [("block", c) for c in _encoder_calls(I2PNetProjConfig(), 160, 512)]
    cases += [("cv1", (1, 256, 480, 128, 128, 64, 64, 64, 128))]
    cases += [("select", level) for level in SELECT_LEVELS]
    return cases


@pytest.mark.parametrize("kind,case", _b1_cases(),
                         ids=[f"{k}-{'x'.join(map(str, c[:2] if k == 'select' else c))}"
                              for k, c in _b1_cases()])
def test_kernels_at_batch_one(dev, kind, case):
    """B=1, as the demo renderers run the model a frame at a time: each
    kernel against its plain version at the bars of its own tests (FPS and
    select exactly, the block within 0.01 * max(|ref|, 1), cv1 within 5e-3),
    one launch a call."""
    rng = np.random.default_rng(len(str(case)))
    mod = {"fps": fps_cuda, "block": conv_cuda, "cv1": cv_cuda, "select": select_cuda}[kind]
    before = mod.launches
    if kind == "fps":
        N, npoint = case
        xyz = torch.from_numpy(rng.uniform(-10, 10, size=(1, N, 3)).astype(np.float32)).to(dev)
        got, ref = fps_cuda.fps_cuda(xyz, npoint), fps_cuda.fps_plain(xyz, npoint)
        assert torch.equal(got, ref)
    elif kind == "block":
        H, W, cin, cout, stride = case
        xb = torch.from_numpy(rng.normal(size=(1, H, W, cin)).astype(np.float32)).to(
            dev, torch.bfloat16)
        wb = torch.from_numpy((rng.normal(size=(3, 3, cin, cout)) / (3 * cin**0.5)).astype(
            np.float32)).to(dev, torch.bfloat16)
        scale, shift = (torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32)).to(dev)
                        for _ in range(2))
        got = conv_cuda.conv_block_cuda(xb, wb, scale, shift, stride).float()
        ref = conv_cuda.conv_block_plain(xb, wb, scale, shift, stride).float()
        assert got.shape == ref.shape == (1, -(-H // stride), -(-W // stride), cout)
        assert float((got - ref).abs().max()) <= 0.01 * max(float(ref.abs().max()), 1.0)
    elif kind == "cv1":
        ops = _cv1_operands(dev, *case)
        got, ref = cv_cuda.cv1_cuda(*ops), cv_cuda.cv1_plain(*ops)
        assert got.shape == ref.shape and bool(torch.isfinite(got).all())
        assert float((got - ref).abs().max()) <= 5e-3
    else:
        grid, out_hw, qstride, kernel, K, distance = case
        xyz = torch.from_numpy(_range_grid(rng, 1, *grid)).to(dev)
        got = select_cuda.selection_multiplicity_cuda(xyz, *out_hw, qstride, kernel, K, distance)
        ref = select_cuda.selection_multiplicity_plain(xyz, *out_hw, qstride, kernel, K, distance)
        assert torch.equal(got, ref) and bool((got.sum(-1) == K).all())
    torch.cuda.synchronize()
    assert mod.launches == before + 1


def _dp_cases():
    """A rank's kernel calls on the data-parallel paths, two ranks on the
    global batch of 8: the train kernels of every encoder block of the
    free and the proj step at B=4, and the eval kernels of a cascade
    stage at the evaluator's per-rank sizes, B=4 and the ragged 1-3."""
    from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig

    cases = [("train", (4,) + c) for c in _encoder_calls(I2PNetConfig(), 384, 1280)]
    cases += [("train", (4,) + c) for c in _encoder_calls(I2PNetProjConfig(), 160, 512)]
    for B in (1, 2, 3, 4):
        cases += [("fps", (B,)), ("cv1", (B,)), ("select", (B,)), ("block_free", (B,)),
                  ("block_proj", (B,))]
    return cases


@pytest.mark.parametrize("kind,case", _dp_cases(),
                         ids=[f"{k}-{'x'.join(map(str, c))}" for k, c in _dp_cases()])
def test_kernels_at_dp_batch_sizes(dev, kind, case):
    """Each kernel against its plain version at the bars of its own tests,
    one launch a call: (a) within 0.01 * max(|ref|, 1), (b) within 2e-3 of
    its largest entry and bit-identical on a repeat, (c) and (d) exactly;
    FPS and select exactly, the block within 0.01 * max(|ref|, 1), cv1
    within 5e-3."""
    from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig

    ct = conv_train_cuda
    B = case[0]
    rng = np.random.default_rng(len(str(case)) + B)
    if kind == "train":
        _, H, W, cin, cout, stride = case
        x = _bf16(dev, rng, B, H, W, cin)
        w = _bf16(dev, rng, cout, 3, 3, cin, s=0.3)
        b = torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32)).to(dev)
        g = _bf16(dev, rng, B, H, W, cout)
        before = dict(ct.launches)
        y, ref = ct.conv_fwd_cuda(x, w, b), ct.conv_fwd_plain(x, w, b)
        assert float((y.float() - ref.float()).abs().max()) <= 0.01 * max(
            float(ref.float().abs().max()), 1.0)
        if cin % 8 == 0:  # the step's dx: every block but the image's
            wt = w.flip(1, 2).permute(3, 1, 2, 0).contiguous()
            dx, ref = ct.conv_dx_cuda(g, wt), ct.conv_dx_plain(g, wt)
            assert float((dx.float() - ref.float()).abs().max()) <= 0.01 * max(
                float(ref.float().abs().max()), 1.0)
        dw, dw2 = ct.conv_dw_cuda(x, g), ct.conv_dw_cuda(x, g)
        ref = ct.conv_dw_plain(x, g)
        torch.cuda.synchronize()
        assert torch.equal(dw, dw2)
        assert float((dw - ref).abs().max()) <= 2e-3 * float(ref.abs().max())
        sc = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32)).to(dev)
        sh = torch.from_numpy((0.1 * rng.normal(size=cout)).astype(np.float32)).to(dev)
        out, taps = ct.bn_pool_fwd_cuda(y, sc, sh, stride)
        out_ref, taps_ref = ct.bn_pool_fwd_plain(y, sc, sh, stride)
        assert torch.equal(out, out_ref) and torch.equal(taps, taps_ref)
        go = _bf16(dev, rng, *out.shape)
        dz = ct.bn_pool_bwd_cuda(y, sc, sh, taps, go, stride)
        torch.cuda.synchronize()
        assert torch.equal(dz, ct.bn_pool_bwd_plain(y, sc, sh, taps, go, stride))
        want = {"conv_fwd": 1, "conv_dx": int(cin % 8 == 0), "conv_dw": 2, "bn_pool_fwd": 1,
                "bn_pool_bwd": 1}
        assert {k: ct.launches[k] - before[k] for k in want} == want
        return
    mod = {"fps": fps_cuda, "cv1": cv_cuda, "select": select_cuda, "block_free": conv_cuda,
           "block_proj": conv_cuda}[kind]
    before = mod.launches
    if kind == "fps":
        levels = [(8192, 2048), (2048, 1024), (1024, 256), (256, 64)]
        for N, npoint in levels:
            xyz = torch.from_numpy(rng.uniform(-10, 10, size=(B, N, 3)).astype(np.float32)).to(dev)
            assert torch.equal(fps_cuda.fps_cuda(xyz, npoint), fps_cuda.fps_plain(xyz, npoint))
        calls = len(levels)
    elif kind == "cv1":
        ops = _cv1_operands(dev, B, 256, 480, 128, 128, 64, 64, 64, 128)
        got, ref = cv_cuda.cv1_cuda(*ops), cv_cuda.cv1_plain(*ops)
        assert got.shape == ref.shape and bool(torch.isfinite(got).all())
        assert float((got - ref).abs().max()) <= 5e-3
        calls = 1
    elif kind == "select":
        for grid, out_hw, qstride, kernel, K, distance in SELECT_LEVELS:
            xyz = torch.from_numpy(_range_grid(rng, B, *grid)).to(dev)
            got = select_cuda.selection_multiplicity_cuda(xyz, *out_hw, qstride, kernel, K, distance)
            ref = select_cuda.selection_multiplicity_plain(xyz, *out_hw, qstride, kernel, K,
                                                           distance)
            assert torch.equal(got, ref) and bool((got.sum(-1) == K).all())
        calls = len(SELECT_LEVELS)
    else:
        cfg, hw = ((I2PNetConfig(), (384, 1280)) if kind == "block_free"
                   else (I2PNetProjConfig(), (160, 512)))
        blocks = _encoder_calls(cfg, *hw)
        for H, W, cin, cout, stride in blocks:
            xb = _bf16(dev, rng, B, H, W, cin)
            wb = torch.from_numpy((rng.normal(size=(3, 3, cin, cout)) / (3 * cin**0.5)).astype(
                np.float32)).to(dev, torch.bfloat16)
            scale, shift = (torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32)).to(dev)
                            for _ in range(2))
            got = conv_cuda.conv_block_cuda(xb, wb, scale, shift, stride).float()
            ref = conv_cuda.conv_block_plain(xb, wb, scale, shift, stride).float()
            assert got.shape == ref.shape == (B, -(-H // stride), -(-W // stride), cout)
            assert float((got - ref).abs().max()) <= 0.01 * max(float(ref.abs().max()), 1.0)
        calls = len(blocks)
    torch.cuda.synchronize()
    assert mod.launches == before + calls
