"""What the redesigned FPS and dw kernels rest on, checked on the CPU.

FPS: the plain loop, which the card's kernel must equal exactly, against
JAX's Pallas kernel in interpret mode on coordinates quantised to a coarse
grid, where equal maxima (ties to the lowest index) are common.

dw: the launch plan of kernel (b) (``_dw_plan``, ``dw_chunks``), which the
kernel reads as it is: every pixel of every encoder conv of the free and
proj paths in exactly one chunk, in an order fixed by the shape alone, and
within what the kernel's launcher accepts.

conv: the launch plan of kernel (a) (``_conv_plan``, ``conv_blocks``), the
mirror of the source's ``conv_plan``: every output pixel and channel of
every forward and dx call of the free and proj train steps, and of odd
shapes, in exactly one block; the layout within a block's shared memory;
and the train gate admitting every stage its earlier form admitted.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from i2pnet_tpu.ops.fps_pallas import fps_pallas
from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
from i2pnet_tpu_torch.ops import conv_train_cuda as ct
from i2pnet_tpu_torch.ops import fps_cuda
from _torch_util import t


@pytest.mark.parametrize("B,N,npoint,step,seed", [(2, 1024, 256, 1.0, 0), (2, 1024, 256, 0.5, 1),
                                                  (1, 256, 64, 2.0, 2)])
def test_fps_plain_matches_jax_on_tied_coordinates(B, N, npoint, step, seed):
    rng = np.random.default_rng(seed)
    xyz = (np.round(rng.normal(size=(B, N, 3)) * 3 / step) * step).astype(np.float32)
    got = fps_cuda.fps_plain(t(xyz), npoint).numpy()
    ref = np.asarray(fps_pallas(jnp.asarray(xyz), npoint, interpret=True))
    np.testing.assert_array_equal(got, ref)
    # the grid makes equal maxima common: the tie rule decides many steps
    x = xyz[0].astype(np.float64)
    dist, ties = np.full(N, np.inf), 0
    for i in got[0][:-1]:
        dist = np.minimum(dist, ((x - x[i]) ** 2).sum(-1))
        ties += int((dist == dist.max()).sum() > 1)
    assert ties > npoint // 4


def _encoder_convs(cfg, B, H, W):
    """(B, H, W, cin, cout) of every conv of the RGB encoder on a BxHxW image."""
    shapes = []
    for cin, channels, strides in cfg.rgb_encoder_channels:
        for cout, s in zip(channels, strides):
            shapes.append((B, H, W, cin, cout))
            H, W, cin = (H - 1) // s + 1, (W - 1) // s + 1, cout
    return shapes


# B=4: a rank's rows of the global batch of 8 on two ranks (the DP step)
DW_SHAPES = sorted(set(
    _encoder_convs(I2PNetConfig(), 8, 384, 1280) + _encoder_convs(I2PNetProjConfig(), 8, 160, 512)
    + _encoder_convs(I2PNetConfig(), 4, 384, 1280) + _encoder_convs(I2PNetProjConfig(), 4, 160, 512)
    + [(1, 37, 45, 8, 24), (2, 16, 32, 3, 16), (1, 5, 300, 5, 8), (1, 9, 17, 128, 64),
       (1, 11, 40, 6, 8)]))


def test_dw_shapes_cover_the_seven_encoder_pairs():
    pairs = {(cin, cout) for _, _, _, cin, cout in _encoder_convs(I2PNetConfig(), 8, 384, 1280)}
    assert pairs == {(3, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 64), (64, 128)}


@pytest.mark.parametrize("B,H,W,cin,cout", DW_SHAPES)
def test_dw_plan_covers_every_pixel_once(B, H, W, cin, cout):
    plan = ct._dw_plan(B, H, W, cin, cout)
    # what conv_dw_launch accepts (csrc/conv_train.cu)
    assert plan.sw % 16 == 0 and 16 <= plan.sw <= ct._DW_SLAB
    assert plan.slabs * plan.sw >= W and plan.rows * plan.rowchunks >= H
    assert plan.nchunks == B * plan.slabs * plan.rowchunks
    assert plan.co_t in (16, 32) and plan.cotiles * plan.co_t >= cout
    if plan.raw:
        assert cin <= 5 and plan.citiles == 1 and plan.ci_t == 48
    else:
        assert plan.ci_t in (16, 32, 64) and plan.citiles * plan.ci_t >= cin
    assert plan.citiles * plan.cotiles <= ct._DW_COUNTERS
    chunks = list(ct.dw_chunks(plan, H, W))
    seen = np.zeros((B, H, W), np.int32)
    for b, (r0, r1), (c0, c1) in chunks:
        seen[b, r0:r1, c0:c1] += 1
    assert (seen == 1).all()
    # the order, and so the order of the sums, depends on the shape alone
    assert chunks == list(ct.dw_chunks(ct._dw_plan(B, H, W, cin, cout), H, W))
    assert [c[0] for c in chunks] == sorted(c[0] for c in chunks)


def _step_conv_calls(cfg, B, H, W):
    """(B, H, W, cin, cout) of kernel (a)'s calls in a train step: each
    encoder conv's forward, and dx (cout -> cin) of all but the first."""
    calls = []
    for i, (b, h, w, cin, cout) in enumerate(_encoder_convs(cfg, B, H, W)):
        calls.append((b, h, w, cin, cout))
        if i > 0:
            calls.append((b, h, w, cout, cin))
    return calls


CONV_SHAPES = sorted(set(
    _step_conv_calls(I2PNetConfig(), 8, 384, 1280) + _step_conv_calls(I2PNetProjConfig(), 8, 160, 512)
    + _step_conv_calls(I2PNetConfig(), 4, 384, 1280)
    + _step_conv_calls(I2PNetProjConfig(), 4, 160, 512)
    + [(1, 37, 45, 8, 24), (1, 43, 211, 16, 16), (1, 29, 150, 5, 16), (1, 29, 150, 8, 16),
       (1, 12, 40, 176, 64), (1, 1, 1, 12, 24), (2, 5, 300, 3, 8), (1, 7, 9, 24, 128),
       (3, 130, 17, 40, 56), (1, 9, 1000, 64, 8)]))


@pytest.mark.parametrize("B,H,W,cin,cout", CONV_SHAPES)
def test_conv_plan_covers_every_output_once(B, H, W, cin, cout):
    plan = ct._conv_plan(B, H, W, cin, cout)
    assert plan is not None
    # what conv3x3_launch_plan accepts (csrc/conv_train.cu)
    assert plan.co_t % 8 == 0 and plan.co_t <= 64 and cout % plan.co_t == 0
    assert 1 <= plan.mt <= 8 and 1 <= plan.sw <= 16 * plan.mt
    assert plan.slabs * plan.sw >= W and plan.rows * plan.rowchunks >= H
    assert plan.rows % ct._CONV_ROWS == 0
    assert ct._conv_smem(cin, plan.co_t, plan.mt) <= ct._CONV_SMEM_MAX < 232448
    seen = np.zeros((B, H, W, cout), np.int32)
    for b, (r0, r1), (c0, c1), (o0, o1) in ct.conv_blocks(plan, B, H, W, cout):
        seen[b, r0:r1, c0:c1, o0:o1] += 1
    assert (seen == 1).all()
    assert ct._conv_plan(B, H, W, cin, cout) == plan  # a function of the shape alone


def test_conv_plan_fills_the_card_on_the_free_step():
    """Every call of the free step gets blocks for at least 90% of the SMs
    (strips are whole iterations of 4 rows, so the 24-row calls cannot
    always take one block each), and the plan the sweep of other plans
    found fastest for the heaviest calls."""
    for B, H, W, cin, cout in _step_conv_calls(I2PNetConfig(), 8, 384, 1280):
        plan = ct._conv_plan(B, H, W, cin, cout)
        blocks = B * plan.slabs * plan.rowchunks * (cout // plan.co_t)
        assert blocks >= 0.9 * ct._SMS, (B, H, W, cin, cout, plan)
    # (co_t, mt): one read of each input row; 3 blocks a SM at stage 1
    assert ct._conv_plan(8, 192, 640, 16, 16)[:2] == (16, 6)
    assert ct._conv_plan(8, 192, 640, 32, 16)[:2] == (16, 4)
    assert ct._conv_plan(8, 24, 80, 128, 64)[:2] == (64, 1)


# the parent's train gate (kernel (a)'s earlier 18x18-tile layout) on one
# block at 24x40 and 7x300, stride 1: for each cin, the couts it admitted
# without an input gradient, and with one (dx needs cin % 8 == 0)
ALL_COUTS = (8, 16, 24, 32, 40, 64, 96, 128)
PARENT_GATE = {
    3: (ALL_COUTS, ()), 5: (ALL_COUTS, ()), 8: (ALL_COUTS, ALL_COUTS), 12: (ALL_COUTS, ()),
    16: (ALL_COUTS, ALL_COUTS), 24: (ALL_COUTS, ALL_COUTS), 32: (ALL_COUTS, ALL_COUTS),
    64: (ALL_COUTS, ALL_COUTS), 128: (ALL_COUTS, ALL_COUTS), 176: (ALL_COUTS, ALL_COUTS),
    192: ((8, 16, 24, 40), (8, 16, 24, 40)), 240: ((8, 16, 24, 40), (8, 16, 24, 40)),
    256: ((8, 24, 40), (8, 24, 40)), 272: ((8, 24, 40), (8, 24, 40)), 288: ((), ()),
}


@pytest.mark.parametrize("H,W", [(24, 40), (7, 300)])
@pytest.mark.parametrize("cin", sorted(PARENT_GATE))
def test_train_gate_admits_what_it_admitted(H, W, cin):
    plain, grad = PARENT_GATE[cin]
    for cout in plain:
        assert ct.stage_supported_train(H, W, cin, (cout,), (1,)), (cin, cout)
    for cout in grad:
        assert ct.stage_supported_train(H, W, cin, (cout,), (1,), input_grad=True), (cin, cout)
    # and still refuses what no kernel takes: dx into channels not a multiple of 8
    if cin % 8:
        assert not ct.stage_supported_train(H, W, cin, (16,), (1,), input_grad=True)
