"""Determinism helpers (port of ``i2pnet_tpu/utils/seeding.py``): the
host's Python and numpy generators, as in the JAX package, and torch's
generators, the card's included."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int = 0) -> None:
    random.seed(seed)
    np.random.seed(seed)
    # seeds the CPU generator and, where CUDA is initialised or later
    # initialised, every card's default generator
    torch.manual_seed(seed)



def worker_seed(base_seed: int, worker_id: int) -> int:
    """A loader worker's seed derived from the run's (the reference's
    ``seed_worker``), as the JAX package derives it."""
    return (base_seed * 1000003 + worker_id) % (2**31 - 1)
