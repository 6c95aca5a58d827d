"""Data parallelism on ``torch.distributed`` (port of
``i2pnet_tpu/parallel``): one process per card, global-batch statistics."""

from i2pnet_tpu_torch.parallel.distributed import (
    barrier,
    host_batch_slice,
    maybe_initialize_distributed,
    process_info,
)
from i2pnet_tpu_torch.parallel.mesh import (
    Mesh,
    ambient_mesh,
    average_gradients_,
    average_metrics,
    fan_out_rows,
    gather_rows,
    global_means,
    make_mesh,
    replicate_,
    set_mesh,
    shard_train_step,
)

__all__ = [
    "Mesh",
    "ambient_mesh",
    "average_gradients_",
    "average_metrics",
    "barrier",
    "fan_out_rows",
    "gather_rows",
    "global_means",
    "host_batch_slice",
    "make_mesh",
    "maybe_initialize_distributed",
    "process_info",
    "replicate_",
    "set_mesh",
    "shard_train_step",
]
