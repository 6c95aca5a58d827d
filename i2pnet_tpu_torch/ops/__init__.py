"""Operations: point ops, quaternions and the CUDA kernels with their plain versions."""

# registers the eval kernels' torch.library ops (torch.ops.i2pnet.*), which
# the routed entry points call
from i2pnet_tpu_torch.ops import library  # noqa: F401
