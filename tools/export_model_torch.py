#!/usr/bin/env python
"""Export a model of the PyTorch port as a serialized ``torch.export``
program for serving (the twin of ``tools/export_model.py``).

The inference forward ``(rgb, lidar[, raw_xyz], intrinsic) -> {"q", "t"}``
is traced once at static shapes, with the weights stored in the program,
and saved with ``torch.export.save``. The eval kernels are
``torch.library`` ops (``i2pnet_tpu_torch/ops/library.py``), so each stays
one node of the program: a serving host imports torch and that module
(``load_exported``), and no model code.

An exported program holds its device's tensors: export on the device you
serve from (``--device``, the card unless ``cpu``), once per batch size.

Usage:
  python tools/export_model_torch.py --out /tmp/i2pnet.pt2 [--proj] [--tiny]
      [--batch 1] [--ckpt log/run | --best log/run/torch/best/model_rotation_best.pt]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import io
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def build_inference(model, proj: bool):
    """The model's eval forward as a module fn(rgb, lidar[, raw_xyz],
    intrinsic) -> {"q", "t"}, the weights its own (the program stores
    them)."""
    import torch

    class FreePoint(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, rgb, lidar, intrinsic):
            out3 = self.model(rgb, lidar, intrinsic)["out3"]
            return {"q": out3[:, :4], "t": out3[:, 4:]}

    class Projective(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, rgb, lidar, raw_xyz, intrinsic):
            out3 = self.model(rgb, lidar, raw_xyz, intrinsic)["out3"]
            return {"q": out3[:, :4], "t": out3[:, 4:]}

    return (Projective() if proj else FreePoint()).eval()


def example_inputs(cfg, proj: bool, batch: int, img_hw=None, points=None, device="cpu"):
    """The JAX tool's example inputs, the same numpy draws in the same order
    (``default_rng(0)``), as tensors on ``device``."""
    import torch

    rng = np.random.default_rng(0)
    if proj:
        h, w = img_hw or (160, 512)
        # the point budget follows the config: a --tiny export does not trace
        # the 150k-point production shape
        n = points or (150000 if img_hw is None else 4096)
        raw = rng.normal(size=(batch, n, 3)).astype(np.float32) * 15
        raw[:, n - 30000:] = 0.0
        lidar = raw.copy()
        intr = np.tile(np.asarray([[[350.0, 0, w // 2], [0, 350.0, h // 2], [0, 0, 1]]],
                                  np.float32), (batch, 1, 1))
        arrays = (rng.normal(size=(batch, h, w, 3)).astype(np.float32), lidar, raw, intr)
    else:
        h, w = img_hw or (384, 1280)
        lidar = rng.uniform(-10, 10, size=(batch, cfg.lidar_in_points, 3)).astype(np.float32)
        lidar[..., 2] += 20.0
        intr = np.tile(np.asarray([[[718.0, 0, w // 2], [0, 718.0, h // 2], [0, 0, 1]]],
                                  np.float32), (batch, 1, 1))
        arrays = (rng.normal(size=(batch, h, w, 3)).astype(np.float32), lidar, intr)
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def export_program(model, cfg, proj: bool, batch: int, img_hw=None, points=None):
    """The ``ExportedProgram`` of the model's eval forward at the example
    inputs' static shapes, on the model's device."""
    import torch

    device = next(model.parameters()).device
    args = example_inputs(cfg, proj, batch, img_hw, points, device)
    with torch.no_grad():
        return torch.export.export(build_inference(model, proj), args, strict=False)


def export_model(model, cfg, proj: bool, batch: int, img_hw=None, points=None) -> bytes:
    """Trace and serialize; returns the artifact's bytes."""
    import torch

    buf = io.BytesIO()
    torch.export.save(export_program(model, cfg, proj, batch, img_hw, points), buf)
    return buf.getvalue()


def load_exported(blob: bytes):
    """Deserialize an artifact: a module fn(*inputs) -> {"q", "t"}. Needs only
    torch and the port's op library (which registers the kernels' ops)."""
    import torch

    import i2pnet_tpu_torch.ops.library  # noqa: F401  (registers torch.ops.i2pnet.*)

    return torch.export.load(io.BytesIO(blob)).module()


def best_snapshot(path: str):
    """(log dir, snapshot name) of a best snapshot file
    ``<log dir>/torch/best/<name>.pt``."""
    best_dir = os.path.dirname(os.path.abspath(path))
    name, ext = os.path.splitext(os.path.basename(path))
    if ext != ".pt" or os.path.basename(best_dir) != "best":
        raise SystemExit(f"--best takes <log dir>/torch/best/<name>.pt, got {path}")
    return os.path.dirname(os.path.dirname(best_dir)), name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--proj", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--ckpt", default=None,
                    help="Trainer log dir to load the weights from (latest step)")
    ap.add_argument("--best", default=None,
                    help="best snapshot (<log dir>/torch/best/model_rotation_best.pt)")
    ap.add_argument("--device", default=None,
                    help="the device the program runs on: the card unless 'cpu'")
    args = ap.parse_args(argv)

    import torch

    from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
    from i2pnet_tpu_torch.models import I2PNet, I2PNetProj, init_flax_
    from i2pnet_tpu_torch.train.checkpoint import restore_inference_variables

    if args.proj:
        cfg = I2PNetProjConfig.tiny() if args.tiny else I2PNetProjConfig()
        model = I2PNetProj(cfg, device=args.device)
    else:
        cfg = I2PNetConfig.tiny() if args.tiny else I2PNetConfig()
        model = I2PNet(cfg, device=args.device)
    img_hw = (64, 128) if args.tiny else None
    init_flax_(model, torch.Generator().manual_seed(0))
    if args.best:
        log_dir, name = best_snapshot(args.best)
        model.load_state_dict(restore_inference_variables(log_dir, model, best=name))
    elif args.ckpt:
        model.load_state_dict(restore_inference_variables(args.ckpt, model, best="latest"))
    model.eval()

    blob = export_model(model, cfg, args.proj, args.batch, img_hw=img_hw)
    with open(args.out, "wb") as f:
        f.write(blob)
    device = next(model.parameters()).device
    print(f"wrote {args.out} ({len(blob) / 1e6:.1f} MB, device={device})")

    # roundtrip smoke: deserialize and run
    with open(args.out, "rb") as f:
        fn = load_exported(f.read())
    ex = example_inputs(cfg, args.proj, args.batch, img_hw, device=device)
    with torch.no_grad():
        out = fn(*ex)
    q = out["q"].float().cpu().numpy()
    print(f"roundtrip ok: q[0]={q[0].round(4).tolist()} |q|={np.linalg.norm(q[0]):.4f}")
    return out


if __name__ == "__main__":
    main()
