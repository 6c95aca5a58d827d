#!/usr/bin/env python3
"""Convert a reference PyTorch I2PNet checkpoint (``RegNet_v2``'s
``state_dict``, as the paper's weights are released) into a log dir of the
PyTorch / CUDA port, which ``evaluate_torch.py`` then evaluates.

Reads the file with ``torch.load(..., weights_only=True)``, takes its
``model_state_dict`` where it has one and strips a leading DataParallel
``module.``, maps the names and layouts by the rules of
``tools/convert_torch_checkpoint.py`` (``i2pnet_tpu_torch/convert.py``
``reference_to_state_dict``), loads the result strictly into the port's
model built on the CPU at the family's shipped config, and writes it as the best
snapshot ``--best`` with the port's ``CheckpointManager``:
``<out_dir>/torch/best/<best>.pt``. Needs torch and numpy only:

    python3 tools/reference_ckpt_to_torch.py ckpt.pt log/ref [--proj]
    python3 evaluate_torch.py --model_dir log/ref [--network i2pnet]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def load_reference(path: str) -> dict:
    """The checkpoint at ``path`` read with ``weights_only=True``. A file that
    holds more than tensors, numbers, strings and containers of them (a
    pickled optimizer or argparse object, say) is refused with an error
    that names it: it is not read with ``weights_only=False``."""
    import pickle

    import torch

    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path}: torch.load(weights_only=True) refused it, as it holds objects besides "
            f"tensors and plain containers. Save its state_dict alone (torch.save(ckpt"
            f"['model_state_dict'], path)) where the file is trusted, and convert that "
            f"({str(e).splitlines()[0]})") from None


def convert(ckpt: str, out_dir: str, proj: bool = False,
            best: str = "model_rotation_best", model=None) -> str:
    """Convert ``ckpt`` into the log dir ``out_dir``; returns the written
    snapshot's path. ``model`` is the port model to load into (the family's
    shipped config, built on the CPU, by default)."""
    from i2pnet_tpu_torch.cli import build
    from i2pnet_tpu_torch.convert import reference_to_state_dict
    from i2pnet_tpu_torch.train.checkpoint import CheckpointManager

    sd = reference_to_state_dict(load_reference(ckpt), proj)
    if model is None:
        model = build(argparse.Namespace(network="i2pnet_proj" if proj else "i2pnet", tiny=False,
                                         dataset="kd_corr_nolidar", compute_dtype="float32",
                                         device="cpu", seed=0))[0]
    model.load_state_dict(sd, strict=True)
    CheckpointManager(out_dir).save_best(best, {"model": model.state_dict()})
    return os.path.join(os.path.abspath(out_dir), "torch", "best", f"{best}.pt")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt", help="the reference checkpoint (.pt / .pth / .tar)")
    ap.add_argument("out_dir", help="the port log dir to write")
    ap.add_argument("--proj", action="store_true",
                    help="the checkpoint is a projection-family model")
    ap.add_argument("--best", default="model_rotation_best",
                    help="the best-snapshot name to write (evaluate_torch.py --best)")
    args = ap.parse_args(argv)
    path = convert(args.ckpt, args.out_dir, args.proj, args.best)
    print(f"{args.ckpt} -> {path}")
    return path


if __name__ == "__main__":
    main()
