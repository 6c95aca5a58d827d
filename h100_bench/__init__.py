"""The benchmark of i2pnet_tpu_torch on the NVIDIA H100 (``run.py``)."""
