"""Helpers of the port (port of ``i2pnet_tpu/utils``)."""
