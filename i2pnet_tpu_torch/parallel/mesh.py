"""Data parallelism over ranks (port of ``i2pnet_tpu/parallel/mesh.py``).

The JAX package's layout: parameters replicated, the batch split on axis
0, and every batch reduction taken over the global batch (XLA turns them
into psums). A DP step on W ranks is the one-process step on the global
batch, up to the order of its sums. Here each rank holds its rows and the
model; the reductions that span the batch are made global by hand:

  * the normalisations' batch statistics (``nn/layers.py`` ``BatchNorm``
    and ``BatchStatsNorm``, the fused encoder's moments in
    ``ops/conv_train_cuda.py``, the dense window's weighted statistics in
    ``ops/dense_window.py``) read the ambient mesh (``set_mesh``, the
    stand-in for ``jax.set_mesh``) and all-reduce their f32 sums and
    their element count with ``global_means``. The all-reduce is
    differentiable, its backward the sum of the cotangents over the ranks
    (psum's transpose), so the gradients through the statistics are the
    global batch's. A plain ``DistributedDataParallel`` wrap would leave
    every BatchNorm normalising by its rank's rows;
  * the train step (``train/step.py``) averages every gradient over the
    ranks after its accumulation loop and before the clip, and averages
    its metrics (``average_gradients_``, ``average_metrics``): every loss
    on a step path is a mean over equal per-rank row counts;
  * the evaluator's fan-out gathers each rank's out3 (``gather_rows``).

Outside ``set_mesh`` every module runs as a single process does. The
(data, space) mesh of the JAX package (``make_mesh_2d``,
``shard_train_step_spatial``) is not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The port's stand-in for a 1-D 'data' mesh over the default process
    group: this rank, the rank count and the rank's device."""

    rank: int
    size: int
    device: torch.device


def make_mesh(device=None) -> Mesh:
    """The mesh of the initialised process group (see
    ``parallel/distributed.py``) on this rank's device: ``device``, or the
    current card (the CPU where there is none)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no process group: launch one process per card with torchrun --nproc_per_node N "
            "(parallel.maybe_initialize_distributed joins it)")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(dist.get_rank(), dist.get_world_size(), device)


class _Ambient:
    mesh: Optional[Mesh] = None
    valid: Optional[int] = None


_AMBIENT = _Ambient()


@contextlib.contextmanager
def set_mesh(mesh: Optional[Mesh], valid: Optional[int] = None):
    """Make ``mesh`` ambient: the normalisations inside take their batch
    statistics over every rank's rows. ``valid``: how many leading rows of
    this rank's tensors count (the evaluator's padded tail does not);
    None counts them all. ``set_mesh(None)`` is a plain single-process
    region."""
    prev = (_AMBIENT.mesh, _AMBIENT.valid)
    _AMBIENT.mesh, _AMBIENT.valid = mesh, valid
    try:
        yield
    finally:
        _AMBIENT.mesh, _AMBIENT.valid = prev


def ambient_mesh() -> Optional[Mesh]:
    return _AMBIENT.mesh


class _AllReduceSum(torch.autograd.Function):
    """psum: the sum over the ranks; its backward sums the cotangent over
    the ranks in turn (psum's transpose), so a rank's rows get the
    gradient of every rank's loss through the shared statistics."""

    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The differentiable sum of ``x`` over the ranks."""
    return _AllReduceSum.apply(x)


def global_means(tensors: Sequence[torch.Tensor], dims: Sequence[int],
                 per_row: Optional[int] = None):
    """Under the ambient mesh, the mean over ``dims`` (the batch axis 0 and
    the axes after it) of each tensor, taken over the valid rows of every
    rank; None outside the mesh. One differentiable all-reduce carries the
    f32 sums and the element count (exact in f32 up to 2**24 elements and
    at every count of the shipped shapes). per_row: the count one row adds
    (the product of the other reduced axes unless given, e.g. the dense
    window's N*K selected slots)."""
    mesh, valid = _AMBIENT.mesh, _AMBIENT.valid
    if mesh is None:
        return None
    rows = tensors[0].shape[0] if valid is None else valid
    if per_row is None:
        per_row = math.prod(tensors[0].shape[d] for d in dims[1:])
    sums = [(t if valid is None else t[:valid]).sum(tuple(dims)) for t in tensors]
    flat = torch.cat([s.reshape(-1) for s in sums] + [sums[0].new_full((1,), float(rows * per_row))])
    flat = all_reduce_sum(flat)
    count = flat[-1]
    sizes = [s.numel() for s in sums]
    return [part.reshape(s.shape) / count
            for part, s in zip(torch.split(flat[:-1], sizes), sums)]


@torch.no_grad()
def replicate_(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast every parameter and buffer from rank 0, so that the ranks
    start from one model."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)
    return module


def _flat_all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= mesh.size
    for t, part in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
        t.copy_(part.reshape(t.shape))


@torch.no_grad()
def average_gradients_(params, mesh: Mesh) -> None:
    """Every parameter's ``.grad`` becomes its mean over the ranks, in one
    all-reduce. Every parameter must hold a gradient (a zero one where the
    loss does not reach it), so that each rank reduces the same tensors."""
    grads = [p.grad for p in params]
    if any(g is None for g in grads):
        raise ValueError("a parameter without a gradient: every rank must reduce every leaf")
    _flat_all_reduce_mean_(grads, mesh)


@torch.no_grad()
def average_metrics(metrics: dict, mesh: Mesh) -> dict:
    """The metrics (scalar tensors) averaged over the ranks."""
    keys = list(metrics)
    vals = [metrics[k].detach().clone() for k in keys]
    _flat_all_reduce_mean_(vals, mesh)
    return dict(zip(keys, vals))


def shard_train_step(train_step, mesh: Mesh):
    """The DP form of ``train_step(state, batch, generator=None)``: each
    rank passes its rows of the global batch (the same count on every
    rank, as ``host_batch_slice`` gives them) and its own dropout
    generator; the step runs under ``set_mesh(mesh)``, so its
    normalisations take global statistics and it averages its gradients
    before the clip and its metrics (``train/step.py``). The parameters
    must start replicated (``replicate_``); the ranks then stay equal bit
    for bit."""

    def call(state, batch, generator=None):
        with set_mesh(mesh):
            return train_step(state, batch, generator)

    return call


def fan_out_rows(n: int, mesh: Mesh):
    """The evaluator's pad-and-trim: this rank's row indices into a batch
    of ``n`` rows (ceil(n / W) each, the tail repeating the last row) and
    how many of them are real. A rank past the batch's end gets only
    repeats and 0 real rows, and still runs every collective."""
    per = -(-n // mesh.size)
    start = mesh.rank * per
    idx = np.minimum(np.arange(start, start + per), n - 1)
    return idx, int(max(0, min(per, n - start)))


@torch.no_grad()
def gather_rows(x: torch.Tensor, n: int, mesh: Mesh) -> torch.Tensor:
    """The ranks' ``fan_out_rows`` outputs in global row order, trimmed to
    ``n`` rows, on every rank: each rank writes its rows into a zero buffer
    and one all-reduce sums them (both backends take it on the card)."""
    per = x.shape[0]
    out = x.new_zeros((mesh.size * per,) + tuple(x.shape[1:]))
    out[mesh.rank * per:(mesh.rank + 1) * per] = x
    dist.all_reduce(out)
    return out[:n]
