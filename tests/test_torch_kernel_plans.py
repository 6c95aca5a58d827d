"""What the redesigned FPS and dw kernels rest on, checked on the CPU.

FPS: the plain loop, which the card's kernel must equal exactly, against
JAX's Pallas kernel in interpret mode on coordinates quantised to a coarse
grid, where equal maxima (ties to the lowest index) are common.

dw: the launch plan of kernel (b) (``_dw_plan``, ``dw_chunks``), which the
kernel reads as it is: every pixel of every encoder conv of the free and
proj paths in exactly one chunk, in an order fixed by the shape alone, and
within what the kernel's launcher accepts.
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


DW_SHAPES = sorted(set(
    _encoder_convs(I2PNetConfig(), 8, 384, 1280) + _encoder_convs(I2PNetProjConfig(), 8, 160, 512)
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
