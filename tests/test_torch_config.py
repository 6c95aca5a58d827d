"""The port's own ``I2PNetConfig`` (``i2pnet_tpu_torch/config.py``) against
the JAX package's (``i2pnet_tpu/config.py``): the same fields in the same
order with the same types and defaults, the same ``tiny()`` and the same
``lidar_layer_points``; and likewise its ``I2PNetProjConfig``, with
``tiny()``, ``nuscenes()``, ``lidar_Hs`` and ``lidar_Ws``. The port keeps a copy because it imports nothing
of the JAX package; this test holds the two together."""

import dataclasses

import pytest

from i2pnet_tpu.config import I2PNetConfig as JaxConfig
from i2pnet_tpu.config import I2PNetProjConfig as JaxProjConfig
from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig


def _fields(cls):
    return [(f.name, str(f.type), f.default) for f in dataclasses.fields(cls)]


def test_config_fields_and_defaults_match():
    assert _fields(I2PNetConfig) == _fields(JaxConfig)
    assert dataclasses.asdict(I2PNetConfig()) == dataclasses.asdict(JaxConfig())


@pytest.mark.parametrize("make", ["default", "tiny"])
def test_config_variants_match(make):
    port = I2PNetConfig() if make == "default" else I2PNetConfig.tiny()
    ref = JaxConfig() if make == "default" else JaxConfig.tiny()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.lidar_layer_points == ref.lidar_layer_points
    assert hash(port) == hash(ref)  # frozen and hashable, as the JAX one


def test_proj_config_fields_and_defaults_match():
    assert _fields(I2PNetProjConfig) == _fields(JaxProjConfig)
    assert dataclasses.asdict(I2PNetProjConfig()) == dataclasses.asdict(JaxProjConfig())


@pytest.mark.parametrize("make", ["__call__", "tiny", "nuscenes"])
def test_proj_config_variants_match(make):
    port = I2PNetProjConfig() if make == "__call__" else getattr(I2PNetProjConfig, make)()
    ref = JaxProjConfig() if make == "__call__" else getattr(JaxProjConfig, make)()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.lidar_Hs, port.lidar_Ws) == (ref.lidar_Hs, ref.lidar_Ws)
    assert hash(port) == hash(ref)
