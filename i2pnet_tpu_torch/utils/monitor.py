"""Unified experiment writer (port of ``i2pnet_tpu/utils/monitor.py``).

Fans scalars out to TensorBoard (tensorboardX, if importable)
and an always-on JSONL metrics file; wandb is attached when a project is
given and it is importable. Plain-text append logs (log.txt, log_rotate.txt,
log_trans.txt) and config.json are the JAX package's artifact set. Where
neither optional package is installed, metrics.jsonl carries every scalar.
The JAX writer's ``add_image`` / ``add_images`` serve only the evaluator's
``--vis_rate`` visualisation, which the port does not run yet (ROADMAP
queue 1, item 5); they come with it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch


class UniWriter:
    def __init__(self, log_dir: str, project: Optional[str] = None, enable_tb: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if enable_tb:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except ImportError:
                self._tb = None
        self._wandb = None
        if project is not None:
            try:
                import wandb

                self._wandb = wandb.init(project=project, dir=log_dir)
            except ImportError:
                self._wandb = None

    def config(self, cfg: dict) -> None:
        with open(os.path.join(self.log_dir, "config.json"), "w") as f:
            json.dump(cfg, f, indent=2, default=str)
        if self._wandb is not None:
            self._wandb.config.update(cfg)

    def add_scalar(self, tag: str, value, step: int) -> None:
        """``value``: a number, a numpy scalar or a one-element tensor (a
        tensor on the card is read back, which waits for the device)."""
        if isinstance(value, torch.Tensor):
            value = value.item()
        value = float(np.asarray(value))
        self._jsonl.write(
            json.dumps({"tag": tag, "value": value, "step": step, "ts": time.time()}) + "\n"
        )
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        if self._wandb is not None:
            self._wandb.log({tag: value}, step=step)

    def text_log(self, filename: str, line: str) -> None:
        with open(os.path.join(self.log_dir, filename), "a") as f:
            f.write(line.rstrip("\n") + "\n")

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
