"""Models of the port."""

from i2pnet_tpu_torch.models.i2pnet import I2PNet, init_flax_, init_random_
from i2pnet_tpu_torch.models.i2pnet_proj import I2PNetProj

__all__ = ["I2PNet", "I2PNetProj", "init_flax_", "init_random_"]
