"""The port's own ``I2PNetConfig`` (``i2pnet_tpu_torch/config.py``) against
the JAX package's (``i2pnet_tpu/config.py``): the same fields in the same
order with the same types and defaults, the same ``tiny()`` and the same
``lidar_layer_points``. The port keeps a copy because it imports nothing
of the JAX package; this test holds the two together."""

import dataclasses

import pytest

from i2pnet_tpu.config import I2PNetConfig as JaxConfig
from i2pnet_tpu_torch.config import I2PNetConfig


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
