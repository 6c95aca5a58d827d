#!/usr/bin/env python
"""Convert a JAX trainer log dir's checkpoints into the PyTorch port's.

Reads every epoch checkpoint (params, batch_stats, step and its meta) and
every ``best/<name>`` snapshot with the JAX package's ``CheckpointManager``,
renames and relayouts the variables with ``i2pnet_tpu_torch/convert.py``
``flax_to_state_dict``, and writes them with the port's
``CheckpointManager`` under ``<log_dir>/torch/``, beside the JAX files.
The optimizer state is not converted yet.

Needs jax and orbax, so it runs where the JAX package runs; the converted
log dir is then evaluated with ``evaluate_torch.py`` on any machine:

    python tools/jax_ckpt_to_torch.py log/proj_a log/proj_b
    python3 evaluate_torch.py --model_dir log/proj_a log/proj_b
"""

from __future__ import annotations

import argparse
import os
import sys
import warnings

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def convert(log_dir: str) -> dict:
    """Convert one log dir; returns {"steps": [...], "best": [...]}."""
    from i2pnet_tpu.train.checkpoint import CheckpointManager as JaxManager
    from i2pnet_tpu_torch.convert import flax_to_state_dict
    from i2pnet_tpu_torch.train.checkpoint import CheckpointManager

    src = JaxManager(log_dir)
    steps = list(src._mngr.all_steps())
    dst = CheckpointManager(log_dir, max_to_keep=max(len(steps), 1))
    with warnings.catch_warnings():
        # orbax warns when it restores without a target tree; the tree is
        # read as saved, which is what a conversion wants
        warnings.simplefilter("ignore")
        for step in steps:
            state, meta = src.restore(None, step)
            variables = {"params": state["params"], "batch_stats": state.get("batch_stats", {})}
            dst.save(step, {"model": flax_to_state_dict(variables),
                            "step": int(np.asarray(state["step"]))}, meta)
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
