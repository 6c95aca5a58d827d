"""Input pipeline: batching, shuffling, background prefetch to the card
(port of ``i2pnet_tpu/data/pipeline.py``).

numpy batch assembly overlaps with the device work; ``prefetch_to_device``
copies each batch from pinned host memory with ``non_blocking`` copies on
the current stream, a batch ahead.

Two assembly backends:
  * num_workers == 0 — one background thread (right for this 1-core box);
  * num_workers >= 1 — a forked process pool assembling whole batches in
    parallel with bounded in-flight submission (ref DataLoader(num_workers=8)
    equivalent). Results are consumed strictly in submission order, so
    shuffling stays deterministic for a given seed regardless of worker
    count. Workers run numpy only and never touch CUDA: a child forked
    after the parent made a CUDA context may use no CUDA call.
"""

from __future__ import annotations

import collections
import concurrent.futures
import multiprocessing
import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from i2pnet_tpu_torch.utils.trace import span

# keys the model steps consume; the rest stay host-side for eval/bookkeeping
DEVICE_KEYS = (
    "rgb",
    "lidar",
    "lidar_feats",
    "raw_point_xyz",
    "init_intrinsic",
    "decalib_real_gt",
    "decalib_dual_gt",
    "calib",  # efgh online-calibration matrix (ref data['calib'])
)

# names used by the train-step batch dicts
KEY_RENAMES = {
    "init_intrinsic": "intrinsic",
    "decalib_real_gt": "decalib_q_gt",
    "decalib_dual_gt": "decalib_t_gt",
    "raw_point_xyz": "raw_xyz",
}


def collate(samples: Sequence[dict], device_only: bool = False) -> Dict[str, np.ndarray]:
    """Stack sample dicts into batch arrays (numeric keys only)."""
    out = {}
    keys = DEVICE_KEYS if device_only else samples[0].keys()
    for k in keys:
        if k not in samples[0]:
            continue
        v0 = samples[0][k]
        if isinstance(v0, str):
            out[k] = [s[k] for s in samples]
        elif isinstance(v0, np.ndarray) or np.isscalar(v0):
            out[k] = np.stack([np.asarray(s[k]) for s in samples])
        else:
            out[k] = [s[k] for s in samples]
    return out


def to_model_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Rename loader keys to the train-step schema."""
    return {KEY_RENAMES.get(k, k): v for k, v in batch.items()}


# fork-inherited worker state, keyed per loader: each BatchLoader publishes
# its {dataset, transform} under a unique token BEFORE forking its pool, so
# children see it without per-task pickling and two concurrently-iterated
# loaders cannot clobber each other's state
_WORKER_STATES: Dict[int, dict] = {}
_LOADER_TOKENS = iter(range(1 << 62))


def _assemble_batch(task):
    """Worker-side batch assembly (runs in forked children).

    Forked children inherit a COPY of the dataset's RNG state and the
    parent never consumes it in multiprocess mode, so without reseeding
    every worker (and every epoch) would replay identical augmentation
    draws. Datasets exposing a `rng` attribute are reseeded per task from
    (loader seed, epoch, batch index) — deterministic for a given seed
    regardless of worker count, different across batches and epochs (the
    reference torch DataLoader reseeds workers per epoch the same way,
    ref src/deterministic.py:6-13 seed_worker)."""
    token, bidx, device_only, task_seed = task
    state = _WORKER_STATES[token]
    ds = state["dataset"]
    transform = state["transform"]
    if task_seed is not None and hasattr(ds, "rng"):
        ds.rng = np.random.default_rng(task_seed)
    samples = [ds[int(i)] for i in bidx]
    b = collate(samples, device_only=device_only)
    if transform is not None:
        b = transform(b)
    return b


class BatchLoader:
    """Shuffled epoch iterator with background prefetch.

    dataset: any object with __len__/__getitem__ returning sample dicts.
    num_workers=0 uses one prefetch thread; >=1 uses a forked process pool
    with at most num_workers + prefetch batches in flight (bounded memory).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 2,
        device_only: bool = False,
        transform: Optional[Callable[[dict], dict]] = None,
        num_workers: int = 0,
        host_slice: Optional[Union[slice, np.ndarray]] = None,
    ):
        """host_slice: the rows of each global batch this process assembles,
        a slice or an index array (``parallel.host_batch_rows``, which
        groups a rank's rows by microbatch): every process draws the same seeded
        shuffle and keeps its slice of each batch's indices, so the global
        batch stays the one-process batch while each rank loads only its
        samples. ``len`` counts global batches."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.device_only = device_only
        self.transform = transform
        self.num_workers = num_workers
        self.host_slice = host_slice
        self.seed = seed
        self._epoch = 0
        self.rng = np.random.default_rng(seed)
        self._token = next(_LOADER_TOKENS)
        self._pool: Optional[concurrent.futures.ProcessPoolExecutor] = None

    def close(self) -> None:
        """Shut down the persistent worker pool (no-op if never started)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
            _WORKER_STATES.pop(self._token, None)

    def __del__(self):  # best-effort; explicit close() preferred in tests
        try:
            self.close()
        except Exception:
            pass

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_batches(self) -> List[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        nb = len(self)
        out = [idx[i * self.batch_size : (i + 1) * self.batch_size] for i in range(nb)]
        if self.host_slice is not None:
            out = [b[self.host_slice] for b in out]
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.num_workers >= 1:
            yield from self._iter_multiprocess()
            return
        batches = self._index_batches()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def worker():
            try:
                for bidx in batches:
                    samples = [self.dataset[int(i)] for i in bidx]
                    b = collate(samples, device_only=self.device_only)
                    if self.transform is not None:
                        b = self.transform(b)
                    q.put(b)
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item

    def _get_pool(self) -> concurrent.futures.ProcessPoolExecutor:
        """Persistent worker pool, created lazily on first use and reused
        across epochs (torch DataLoader persistent_workers semantics, ref
        train20v2learn_wandb.py:160-167). Fork-per-epoch was both slow
        (re-forking a large resident dataset) and a latent deadlock with
        the runtime's threads live in the parent; forking ONCE before
        the first epoch's first step minimizes that window.

        Forking after the parent made its CUDA context is safe only because
        the children run numpy alone: a forked child cannot use CUDA."""
        if self._pool is None:
            # publish this loader's state under its token BEFORE forking so
            # the children's snapshot contains it
            _WORKER_STATES[self._token] = {
                "dataset": self.dataset,
                "transform": self.transform,
            }
            ctx = multiprocessing.get_context("fork")
            self._pool = concurrent.futures.ProcessPoolExecutor(
                max_workers=self.num_workers, mp_context=ctx
            )
        return self._pool

    def _iter_multiprocess(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._index_batches()
        epoch = self._epoch
        self._epoch += 1
        pool = self._get_pool()
        max_inflight = self.num_workers + max(self.prefetch, 1)
        pending: "collections.deque" = collections.deque()
        try:
            for bi, bidx in enumerate(batches):
                task_seed = (self.seed, epoch, bi)
                pending.append(
                    pool.submit(
                        _assemble_batch,
                        (self._token, bidx, self.device_only, task_seed),
                    )
                )
                if len(pending) >= max_inflight:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            for f in pending:
                f.cancel()


def _to_device(batch: dict, device: torch.device, keys=None) -> dict:
    """numpy arrays (of ``keys``, or all) -> tensors on ``device``; other
    values as they are. On the card each array is staged in pinned memory
    and copied with ``non_blocking`` on the current stream."""
    out = {}
    with span("i2pnet/data/to_device"):
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and v.dtype != object and (keys is None or k in keys):
                t = torch.from_numpy(np.ascontiguousarray(v))
                if device.type == "cuda":
                    t = t.pin_memory().to(device, non_blocking=True)
                else:
                    t = t.to(device)
                out[k] = t
            else:
                out[k] = v
    return out


def prefetch_to_device(iterator, device=None, size: int = 2, keys=None):
    """Move batches onto ``device`` (the card unless given) ``size`` ahead
    of consumption: every numpy array, or those of ``keys`` (the rest stay
    on the host). The copies run on the current stream, so any work queued
    after them on that stream sees the batch."""
    device = torch.device("cuda" if device is None else device)
    buf: List = []
    it = iter(iterator)
    try:
        for _ in range(size):
            buf.append(_to_device(next(it), device, keys))
    except StopIteration:
        pass
    while buf:
        out = buf.pop(0)
        try:
            buf.append(_to_device(next(it), device, keys))
        except StopIteration:
            pass
        yield out
