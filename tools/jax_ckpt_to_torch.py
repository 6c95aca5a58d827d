#!/usr/bin/env python
"""Convert a JAX trainer log dir's checkpoints into the PyTorch port's.

Reads every epoch checkpoint (params, batch_stats, the optax state, step
and its meta) and every ``best/<name>`` snapshot with the JAX package's
``CheckpointManager``, renames and relayouts the variables with
``i2pnet_tpu_torch/convert.py`` ``flax_to_state_dict``, and writes them
with the port's ``CheckpointManager`` under ``<log_dir>/torch/``, beside
the JAX files.

An epoch checkpoint also carries Adam's moments and count across
(``load_optax_adam_state``) into the port optimizer's ``state_dict``, so
``train_torch.py --resume`` continues the JAX run. That needs the run's
``config.json`` (the trainer writes it): the port model it names is built
on the CPU to order the optimizer's state, with the run's lr, weight decay
and clip. A log dir without one is converted for inference only (a
warning says so), and resuming from it raises.

Needs jax and orbax, so it runs where the JAX package runs; the converted
log dir is then evaluated or resumed on any machine:

    python tools/jax_ckpt_to_torch.py log/proj_a log/proj_b
    python3 evaluate_torch.py --model_dir log/proj_a log/proj_b
    python3 train_torch.py --log_dir log/proj_a --resume ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import warnings

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _tuples(value):
    """JSON lists back to the tuples of a frozen config's fields."""
    return tuple(_tuples(v) for v in value) if isinstance(value, list) else value


def _train_state(log_dir: str):
    """A fresh port ``TrainState`` on the CPU for the run's config.json, or
    None where the log dir has none."""
    path = os.path.join(log_dir, "config.json")
    if not os.path.exists(path):
        return None
    from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
    from i2pnet_tpu_torch.models import I2PNet, I2PNetProj
    from i2pnet_tpu_torch.train import create_train_state

    with open(path) as f:
        run = json.load(f)
    cls, model_cls = (I2PNetProjConfig, I2PNetProj) if run["proj"] else (I2PNetConfig, I2PNet)
    cfg = cls(**{k: _tuples(v) for k, v in run["config"].items()})
    hp = {k: run[k] for k in ("lr", "weight_decay", "clip") if k in run}
    return create_train_state(model_cls(cfg, device="cpu"), **hp)


def convert(log_dir: str) -> dict:
    """Convert one log dir; returns {"steps": [...], "best": [...]}."""
    from i2pnet_tpu.train.checkpoint import CheckpointManager as JaxManager
    from i2pnet_tpu_torch.convert import (
        flax_to_state_dict,
        load_flax_variables,
        load_optax_adam_state,
    )
    from i2pnet_tpu_torch.train.checkpoint import CheckpointManager, state_of

    src = JaxManager(log_dir)
    steps = list(src._mngr.all_steps())
    dst = CheckpointManager(log_dir, max_to_keep=max(len(steps), 1))
    train_state = _train_state(log_dir) if steps else None
    if steps and train_state is None:
        warnings.warn(f"{log_dir} has no config.json: its epoch checkpoints are converted "
                      "without the optimizer state, for inference only")
    with warnings.catch_warnings():
        # orbax warns when it restores without a target tree; the tree is
        # read as saved, which is what a conversion wants
        warnings.simplefilter("ignore")
        for step in steps:
            state, meta = src.restore(None, step)
            variables = {"params": state["params"], "batch_stats": state.get("batch_stats", {})}
            if train_state is None:
                dst.save(step, {"model": flax_to_state_dict(variables),
                                "step": int(np.asarray(state["step"]))}, meta)
                continue
            load_flax_variables(train_state.model, variables)
            load_optax_adam_state(train_state, state["opt_state"])
            dst.save(step, state_of(train_state), meta)
        best_dir = os.path.join(src.directory, "best")
        names = sorted(os.listdir(best_dir)) if os.path.isdir(best_dir) else []
        for name in names:
            snap = src.restore_best(name, None)
            dst.save_best(name, {"model": flax_to_state_dict(snap)})
    src.close()
    return {"steps": steps, "best": names}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("log_dir", nargs="+", help="JAX trainer log dirs")
    args = ap.parse_args(argv)
    for log_dir in args.log_dir:
        done = convert(log_dir)
        print(f"{log_dir}: epoch checkpoints {done['steps']}, best snapshots {done['best']} "
              f"-> {os.path.join(log_dir, 'torch')}")


if __name__ == "__main__":
    main()
