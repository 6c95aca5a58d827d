"""The port's data-parallel plumbing on the CPU, in this process (the
ranks themselves: tests/test_torch_dp_train.py, tests/test_torch_dp_eval.py).

- ``host_batch_slice`` against the JAX package's, rank by rank, and
  ``BatchLoader(host_slice=...)`` against JAX's loader, index for index
  and array for array (the datasets draw from their generators), with one
  thread and with two worker processes;
- ``maybe_initialize_distributed``: nothing without torchrun's
  environment; a half-set one raises and names what is missing (JAX warns
  and trains alone); two ranks on one card raise unless gloo is asked for;
  NCCL is refused on the CPU;
- ``fan_out_rows``: every row of a batch once among the real rows, the
  tail repeating the last row;
- the losses on the step paths are means over the rank's rows: the one
  loss that divides by a batch-wide count (``pointwise_reprojection_loss``)
  is on no step path.
"""

import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import i2pnet_tpu.parallel.distributed as jdist
from i2pnet_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from i2pnet_tpu_torch.data import BatchLoader
from i2pnet_tpu_torch.parallel import Mesh, distributed as D, fan_out_rows

TORCHRUN = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
            "MASTER_PORT")


@pytest.mark.parametrize("B,W", [(8, 1), (8, 2), (8, 4), (6, 3), (32, 4), (6, 4)])
def test_host_batch_slice_matches_jax(B, W, monkeypatch):
    for rank in range(W):
        monkeypatch.setattr(jdist, "process_info", lambda: (rank, W))
        monkeypatch.setattr(D, "process_info", lambda: (rank, W))
        if B % W:
            for fn in (jdist.host_batch_slice, D.host_batch_slice):
                with pytest.raises(ValueError, match="must divide"):
                    fn(B)
        else:
            assert D.host_batch_slice(B) == jdist.host_batch_slice(B)


class DrawingDataset:
    """Samples that draw from the dataset's generator, as the loaders'
    augmentations do (the worker pools reseed ``rng`` per batch)."""

    def __init__(self, count, seed=0):
        self.count = count
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.count

    def __getitem__(self, i):
        return {"rgb": np.full((2, 3, 3), i, np.float32) + self.rng.normal(size=(2, 3, 3)),
                "lidar": self.rng.uniform(size=(5, 3)).astype(np.float32),
                "path_info": f"frame {i}"}


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("rank,world", [(0, 2), (1, 2), (3, 4)])
def test_batch_loader_host_slice_matches_jax(workers, rank, world):
    host = slice(rank * 8 // world, (rank + 1) * 8 // world)
    loaders = [cls(DrawingDataset(27, seed=3), 8, shuffle=True, seed=5, num_workers=workers,
                   host_slice=host) for cls in (BatchLoader, JaxBatchLoader)]
    try:
        assert len(loaders[0]) == len(loaders[1]) == 3  # global batches
        for _ in range(2):  # two epochs: the shuffle and the draws move on
            ours, ref = (list(ld) for ld in loaders)
            assert len(ours) == len(ref) == 3
            for a, b in zip(ours, ref):
                assert a["path_info"] == b["path_info"] and len(a["path_info"]) == 8 // world
                for k in ("rgb", "lidar"):
                    np.testing.assert_array_equal(a[k], b[k])
    finally:
        for ld in loaders:
            ld.close()


@pytest.fixture
def clean_env(monkeypatch):
    for v in TORCHRUN:
        monkeypatch.delenv(v, raising=False)
    return monkeypatch


@pytest.mark.parametrize("env,missing", [
    ({"RANK": "0"}, "WORLD_SIZE"),
    ({"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1"}, "MASTER_ADDR"),
    ({"WORLD_SIZE": "2", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost", "MASTER_PORT": "29500"},
     "RANK"),
])
def test_half_set_environment_raises(env, missing, clean_env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    with pytest.raises(RuntimeError, match=f"half-set torchrun environment.*'{missing}'"):
        D.maybe_initialize_distributed(device="cpu")
    assert not dist.is_initialized()


def test_initialisation_binds_and_refuses(clean_env):
    # no torchrun environment: a single process, nothing initialised
    assert D.maybe_initialize_distributed() is False and D.process_info() == (0, 1)
    assert D.host_batch_slice(8) == slice(0, 8)
    calls = []
    clean_env.setattr(dist, "init_process_group", lambda *a, **k: calls.append((a, k)))
    clean_env.setattr(torch.cuda, "is_available", lambda: True)
    clean_env.setattr(torch.cuda, "device_count", lambda: 1)
    clean_env.setattr(torch.cuda, "set_device", lambda i: calls.append(("card", i)))
    for k, v in dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1", MASTER_ADDR="localhost",
                     MASTER_PORT="29500").items():
        clean_env.setenv(k, v)
    # two ranks on one card: NCCL refuses them, gloo takes them
    with pytest.raises(RuntimeError, match="2 ranks on this host share 1 card"):
        D.maybe_initialize_distributed()
    assert calls == []
    assert D.maybe_initialize_distributed(backend="gloo") is True
    assert calls == [("card", 0), (("gloo",), dict(init_method="env://", rank=1, world_size=2))]
    calls.clear()
    clean_env.setenv("LOCAL_WORLD_SIZE", "1")  # one rank a card on this host: NCCL
    assert D.maybe_initialize_distributed() is True
    assert calls[-1] == (("nccl",), dict(init_method="env://", rank=1, world_size=2))
    with pytest.raises(ValueError, match="NCCL needs the card"):
        D.maybe_initialize_distributed(backend="nccl", device="cpu")


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8])
def test_fan_out_rows_pads_with_the_last_row(n):
    meshes = [Mesh(r, 2, torch.device("cpu")) for r in range(2)]
    parts = [fan_out_rows(n, m) for m in meshes]
    per = -(-n // 2)
    assert all(len(idx) == per for idx, _ in parts)
    real = np.concatenate([idx[:valid] for idx, valid in parts])
    np.testing.assert_array_equal(real, np.arange(n))
    pads = np.concatenate([idx[valid:] for idx, valid in parts])
    assert (pads == n - 1).all() and sum(v for _, v in parts) == n


def test_reprojection_loss_is_on_no_step_path():
    """``pointwise_reprojection_loss`` divides by the batch's in-frustum
    count, which a mean of per-rank gradients would not reproduce: it is
    defined in losses.py and called from no module of the port."""
    root = Path(__file__).resolve().parent.parent / "i2pnet_tpu_torch"
    users = [p for p in root.rglob("*.py")
             if re.search(r"\bpointwise_reprojection_loss\b", p.read_text())]
    assert [os.path.relpath(p, root) for p in users] == ["losses.py"]
