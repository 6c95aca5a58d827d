"""Checkpoints on ``torch.save`` (port of ``i2pnet_tpu/train/checkpoint.py``).

The JAX package's artifact set and roles: per-epoch checkpoints kept up to
``max_to_keep``, each with an optional JSON-able ``meta`` dict, plus named
best snapshots (``model_rotation_best``, ...). They live under
``<log_dir>/torch/`` so that a run converted from the JAX format
(``tools/jax_ckpt_to_torch.py``) sits beside the JAX one:

    <log_dir>/torch/ckpt/<step>.pt    {"state": ..., "meta": ...}
    <log_dir>/torch/best/<name>.pt    {"state": ...}

An epoch checkpoint's state is ``{"model": state_dict, "optimizer":
optimizer.state_dict(), "step": int}`` (``state_of`` builds it from a
``TrainState``; ``restore_train_state`` resumes one from it). The
schedule's position is the update count ``step``. Best snapshots hold the
model alone, as in the JAX package; so does a checkpoint written before
the optimizer was stored, which still loads for inference but cannot be
resumed. Tensors are stored on the CPU, so a checkpoint loads on any
device, and everything in a file is what ``torch.load(...,
weights_only=True)`` reads (tensors, numbers, strings, lists and dicts).
Each file is written to a temporary name and renamed, so a reader never
sees half of one. Under a process group only rank 0 writes (``save`` and
``save_best`` do nothing on the other ranks) and every rank reads.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Optional

import torch

from i2pnet_tpu_torch.parallel.distributed import process_info

SUBDIR = "torch"


def state_of(train_state) -> dict:
    """The checkpointed part of a ``TrainState``: the model's parameters and
    statistics, the optimizer's state and the update count."""
    return {"model": _cpu(train_state.model.state_dict()),
            "optimizer": _cpu(train_state.optimizer.state_dict()),
            "step": int(train_state.step)}


def restore_train_state(train_state, payload: dict) -> None:
    """Resume ``train_state`` from a checkpoint's state (as ``state_of``
    gives it): the model strictly, then the optimizer, then the update
    count, which sets the schedule's rate."""
    if "optimizer" not in payload:
        raise ValueError(
            "the checkpoint holds no optimizer state (a model-only checkpoint, written for "
            "inference or converted without its run's config.json): it loads for "
            "evaluation but cannot resume training")
    train_state.model.load_state_dict(payload["model"], strict=True)
    train_state.optimizer.load_state_dict(payload["optimizer"])
    train_state.set_step(int(payload["step"]))


def _cpu(tree):
    """``tree`` with every tensor detached and on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _write(path: str, payload: dict) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _read(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._ckpt_dir = os.path.join(self.directory, SUBDIR, "ckpt")
        self._best_dir = os.path.join(self.directory, SUBDIR, "best")
        self.writes = process_info()[0] == 0
        if self.writes:
            os.makedirs(self._ckpt_dir, exist_ok=True)
            os.makedirs(self._best_dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._ckpt_dir, f"{int(step)}.pt")

    def all_steps(self):
        steps = []
        if not os.path.isdir(self._ckpt_dir):
            return steps
        for name in os.listdir(self._ckpt_dir):
            stem, ext = os.path.splitext(name)
            if ext == ".pt" and stem.isdigit():
                steps.append(int(stem))
        return sorted(steps)

    def save(self, step: int, state: Any, meta: Optional[dict] = None) -> None:
        """Save ``state`` (a ``TrainState`` or a state dict as ``state_of``
        gives) as epoch checkpoint ``step``; drop the oldest past
        ``max_to_keep``. Rank 0 alone writes."""
        if not self.writes:
            return
        _write(self._path(step), {"state": self._state(state), "meta": meta})
        steps = self.all_steps()
        for old in steps[: max(len(steps) - self.max_to_keep, 0)]:
            os.remove(self._path(old))

    @staticmethod
    def _state(state: Any) -> dict:
        return _cpu(state) if isinstance(state, dict) else state_of(state)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None):
        """Returns (state, meta) of checkpoint ``step`` (the latest if None)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self._ckpt_dir}")
        payload = _read(self._path(step))
        return payload["state"], payload.get("meta")

    def save_best(self, name: str, state: Any) -> None:
        """Overwrite the named best snapshot (e.g. 'model_rotation_best');
        rank 0 alone writes."""
        if not self.writes:
            return
        _write(os.path.join(self._best_dir, f"{name}.pt"), {"state": self._state(state)})

    def has_best(self, name: str) -> bool:
        return os.path.exists(os.path.join(self._best_dir, f"{name}.pt"))

    def restore_best(self, name: str) -> dict:
        return _read(os.path.join(self._best_dir, f"{name}.pt"))["state"]


def restore_inference_variables(log_dir: str, model, best: str = "model_rotation_best"
                                ) -> Dict[str, torch.Tensor]:
    """The model's ``state_dict`` for inference from a training log dir.

    best='latest' takes the newest epoch checkpoint; a name takes that best
    snapshot, and where it is absent (e.g. the run had no validation split)
    warns and takes the newest epoch checkpoint instead, as the JAX package
    does. The keys must be the model's own."""
    mgr = CheckpointManager(log_dir)
    if best != "latest" and not mgr.has_best(best):
        warnings.warn(
            f"best snapshot '{best}' absent under {log_dir}/{SUBDIR}/best; "
            "restoring the latest epoch checkpoint instead"
        )
        best = "latest"
    state = mgr.restore()[0] if best == "latest" else mgr.restore_best(best)
    state_dict = state["model"]
    want = set(model.state_dict())
    if set(state_dict) != want:
        missing, extra = sorted(want - set(state_dict)), sorted(set(state_dict) - want)
        raise ValueError(f"checkpoint under {log_dir} does not fit the model: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    return state_dict
