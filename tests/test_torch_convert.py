"""The weight bridge (i2pnet_tpu_torch/convert.py): every flax leaf maps to
exactly one entry of the port's state_dict, and strict loading passes, for
the tiny and the shipped free-point configs. Shapes come from
jax.eval_shape, so the shipped config is never run here."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from i2pnet_tpu.config import I2PNetConfig
from i2pnet_tpu.models import I2PNet as JaxI2PNet
from i2pnet_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from i2pnet_tpu_torch.models import I2PNet


def _abstract_variables(cfg, H, W, N):
    x = jax.ShapeDtypeStruct((1, H, W, 3), np.float32)
    pts = jax.ShapeDtypeStruct((1, N, 3), np.float32)
    k = jax.ShapeDtypeStruct((1, 3, 3), np.float32)
    return jax.eval_shape(lambda a, b, c: JaxI2PNet(cfg).init(jax.random.key(0), a, b, c), x, pts, k)


@pytest.mark.parametrize(
    "cfg,H,W",
    [
        (I2PNetConfig.tiny(), 64, 128),
        (I2PNetConfig(), 128, 256),
        (dataclasses.replace(I2PNetConfig(), compute_dtype="bfloat16"), 128, 256),
    ],
    ids=["tiny", "shipped", "shipped-bf16"],
)
def test_bridge_covers_every_leaf_and_loads_strict(cfg, H, W):
    shapes = _abstract_variables(cfg, H, W, cfg.lidar_in_points)
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), dict(shapes))
    leaves = jax.tree_util.tree_leaves(variables)

    sd = flax_to_state_dict(variables)
    model = I2PNet(cfg, device="cpu")
    assert len(sd) == len(leaves) == len(model.state_dict())
    load_flax_variables(model, variables)  # strict=True

    # the layout rules, checked on one leaf of each kind
    p, s = variables["params"], variables["batch_stats"]
    conv = p["rgb_encoder"]["RGBEncoderStage_0"]["Conv_0"]["kernel"]
    got = model.rgb_encoder.RGBEncoderStage_0.Conv_0.weight.detach().numpy()
    np.testing.assert_array_equal(got, conv.transpose(3, 2, 0, 1))
    dense = p["cost_volume1"]["mlp1_convs"]["PointwiseConv_0"]["Dense_0"]["kernel"]
    got = model.cost_volume1.mlp1_convs.PointwiseConv_0.Dense_0.weight.detach().numpy()
    np.testing.assert_array_equal(got, dense.T)
    bn = model.lidar_lv1.BatchNorm_0
    np.testing.assert_array_equal(bn.weight.detach().numpy(), p["lidar_lv1"]["BatchNorm_0"]["scale"])
    np.testing.assert_array_equal(bn.running_var.numpy(), s["lidar_lv1"]["BatchNorm_0"]["var"])
    assert float(model.sq.detach()) == float(p["sq"][0])


def test_bridge_rejects_unknown_leaves():
    with pytest.raises(ValueError):
        flax_to_state_dict({"params": {"Dense_0": {"kernal": np.zeros((2, 2))}}})
    with pytest.raises(RuntimeError):  # strict loading: a missing entry
        load_flax_variables(torch.nn.Linear(2, 2), {"params": {"bias": np.zeros(2)}})
