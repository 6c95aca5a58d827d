"""Unified experiment writer (port of ``i2pnet_tpu/utils/monitor.py``).

Fans scalars and images out to TensorBoard (tensorboardX, if importable)
and scalars to an always-on JSONL metrics file; wandb is attached when a
project is given and it is importable. Plain-text append logs (log.txt,
log_rotate.txt, log_trans.txt) and config.json are the JAX package's
artifact set. Where neither optional package is installed, metrics.jsonl
carries every scalar and images go nowhere, as in the JAX package.
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

    def add_image(self, tag: str, img: np.ndarray, step: int) -> None:
        """One (H, W, C) image to TensorBoard and wandb (ref
        monitor/base.py:41-56)."""
        if self._tb is not None:
            self._tb.add_image(tag, img, step, dataformats="HWC")
        if self._wandb is not None:
            import wandb

            self._wandb.log({tag: wandb.Image(np.asarray(img))}, step=step)

    def add_images(self, tag: str, imgs: np.ndarray, step: int) -> None:
        """An (N, H, W, C) batch to TensorBoard; wandb gets the reference's
        H x (W*N) concatenation side by side (ref monitor/base.py:48-56)."""
        imgs = np.asarray(imgs)
        if self._tb is not None:
            self._tb.add_images(tag, imgs, step, dataformats="NHWC")
        if self._wandb is not None:
            import wandb

            b, h, w, c = imgs.shape
            concat = imgs.transpose(1, 2, 0, 3).reshape(h, w * b, c)
            self._wandb.log({tag: wandb.Image(concat)}, step=step)

    def text_log(self, filename: str, line: str) -> None:
        with open(os.path.join(self.log_dir, filename), "a") as f:
            f.write(line.rstrip("\n") + "\n")

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
