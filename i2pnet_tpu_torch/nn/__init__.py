"""Layers and modules of the port, named after the flax scopes."""

from i2pnet_tpu_torch.nn.resnet import BasicBlock, ResNetEncoder  # noqa: F401
