"""Multi-process start-up and the per-rank input slice (port of
``i2pnet_tpu/parallel/distributed.py``).

One process per card. ``torchrun --nproc_per_node N`` starts them (or
``torch.multiprocessing`` with the ``spawn`` start method: the parent
holds a CUDA context, so a forked child could use no CUDA call); every
process runs the same program, ``maybe_initialize_distributed`` joins them
into one process group and binds each to ``cuda:LOCAL_RANK``, and each
loads only its rows of every global batch (``host_batch_slice``). A run
with no torchrun environment is a single process: nothing is initialised
and the "host slice" is the whole batch.

Unlike the JAX package, a half-set environment raises rather than warning
and training alone: on the card that would leave N processes each
training its own model while looking healthy.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

# torchrun's variables: the rank's identity, then the rendezvous that
# init_method="env://" reads
_IDENTITY = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
_RENDEZVOUS = ("MASTER_ADDR", "MASTER_PORT")


def maybe_initialize_distributed(backend: Optional[str] = None, device=None,
                                 init_method: Optional[str] = None) -> bool:
    """Join the process group that torchrun's environment describes; returns
    whether one is initialised (False, and nothing done, without that
    environment). Safe to call unconditionally at start-up.

    device: the ranks' device type (``"cuda"``, the default, or ``"cpu"``).
    On the card each rank is bound to ``cuda:LOCAL_RANK`` and the backend is
    NCCL, which refuses two ranks on one device: where the host has fewer
    cards than ranks this raises unless ``backend="gloo"`` is passed, and
    then rank ``LOCAL_RANK`` takes card ``LOCAL_RANK % count``. On the CPU
    the backend is gloo. init_method: a rendezvous other than torchrun's
    ``env://`` (e.g. ``file://...``); RANK, WORLD_SIZE and LOCAL_RANK are
    still read from the environment."""
    if dist.is_initialized():
        return True
    needed = _IDENTITY + (_RENDEZVOUS if init_method is None else ())
    present = [v for v in needed if v in os.environ]
    if not any(v in os.environ for v in _IDENTITY):
        return False
    missing = [v for v in needed if v not in os.environ]
    if missing:
        raise RuntimeError(
            f"a half-set torchrun environment: {present} set, {missing} missing. Launch with "
            "torchrun --nproc_per_node N, or unset the variables to run one process")
    rank, world, local = (int(os.environ[v]) for v in _IDENTITY)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
        cards = torch.cuda.device_count()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if local_world > cards and backend != "gloo":
            raise RuntimeError(
                f"{local_world} ranks on this host share {cards} card(s): NCCL refuses two ranks "
                "on one device; pass backend='gloo' to run them so anyway")
        torch.cuda.set_device(local % cards)
        backend = backend or "nccl"
    else:
        if backend == "nccl":
            raise ValueError("NCCL needs the card: the CPU ranks take gloo")
        backend = backend or "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world)
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_info() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if not is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def host_batch_slice(global_batch_size: int) -> slice:
    """The rows of a global batch this rank loads: an even split, which
    must divide (the trainer checks it at start-up, as the DP step needs
    equal rows on every rank)."""
    pidx, pcount = process_info()
    if global_batch_size % pcount != 0:
        raise ValueError(f"process count {pcount} must divide global batch {global_batch_size}")
    per = global_batch_size // pcount
    return slice(pidx * per, (pidx + 1) * per)


def barrier(mesh) -> None:
    """Wait for every rank of ``mesh`` (a no-op for None, a single
    process): a one-element all-reduce on the rank's device, which both
    backends take."""
    if mesh is not None:
        dist.all_reduce(torch.zeros(1, device=mesh.device))
