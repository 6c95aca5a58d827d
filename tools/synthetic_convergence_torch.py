#!/usr/bin/env python
"""End-to-end learning check of the PyTorch / CUDA port on geometrically
consistent synthetic data: the twin of ``tools/synthetic_convergence.py``.

Each sample's image encodes its cloud under the ground-truth pose (points
depth-splatted through the intrinsic at the identity extrinsic); the cloud
is then decalibrated by a random (q, t) of up to 10 deg and 1 m. A working
registration network drives RRE and RTE down on a held-out batch; random
images could never show that. The batches are the JAX tool's, drawn by
numpy from seed 0 with the port's ``data/transforms``; the weights start
as the JAX package's do (``init_flax_``, seed 0). Runs on the CUDA card
unless ``--device cpu`` is given, and exits non-zero if RRE or RTE did
not fall.

    python3 tools/synthetic_convergence_torch.py --steps 300
    python3 tools/synthetic_convergence_torch.py --steps 300 --proj
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def make_batch(rng, points, B, img_h, img_w, device, max_deg=10.0, max_t=1.0):
    """B samples of ``points`` points in front of the camera, the image a
    depth splat of the cloud at the identity extrinsic, the cloud
    decalibrated by a random pose; tensors on ``device``."""
    import torch

    from i2pnet_tpu_torch.data import transforms as T

    fx = img_w / 2.0
    K = np.array([[fx, 0, img_w / 2], [0, fx, img_h / 2], [0, 0, 1]], np.float32)
    rgbs, lidars, qs, ts = [], [], [], []
    for _ in range(B):
        pts = np.zeros((points, 3), np.float32)
        pts[:, 0] = rng.uniform(-15, 15, points)
        pts[:, 1] = rng.uniform(-3, 3, points)
        pts[:, 2] = rng.uniform(4, 40, points)
        img = np.zeros((img_h, img_w, 3), np.float32)
        uvw = pts @ K.T
        uv = (uvw[:, :2] / uvw[:, 2:3]).astype(np.int64)
        m = (uv[:, 0] >= 0) & (uv[:, 0] < img_w) & (uv[:, 1] >= 0) & (uv[:, 1] < img_h)
        shade = np.clip(255 * (1 - (pts[:, 2] - 4) / 36), 0, 255)
        img[uv[m, 1], uv[m, 0]] = shade[m, None]

        Pr = T.generate_random_transform(rng, max_t, max_t, max_t, np.deg2rad(max_deg),
                                         np.deg2rad(max_deg), np.deg2rad(max_deg))
        q, t = T.decalib_ground_truth(Pr[:3, :])
        # the decalibrated cloud Pr^-1 @ p, which (q, t) restores to p
        Pr_inv = np.linalg.inv(Pr)
        rgbs.append(img)
        lidars.append((pts @ Pr_inv[:3, :3].T + Pr_inv[:3, 3]).astype(np.float32))
        qs.append(q)
        ts.append(t)
    arrays = {"rgb": np.stack(rgbs), "lidar": np.stack(lidars),
              "intrinsic": np.tile(K[None], (B, 1, 1)), "decalib_q_gt": np.stack(qs),
              "decalib_t_gt": np.stack(ts)}
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def converge(steps: int = 300, batch: int = 8, tiny: bool = False, proj: bool = False,
             img_h: int = 160, img_w: int = 512, report_every: int = 50, dtype=None,
             device=None, step_hook=None):
    """Train ``steps`` steps (a fresh batch every 10) and report RRE (deg)
    and RTE (m) on a held-out batch before and after; returns (rre0, rte0,
    rre1, rte1). The configs are the JAX tool's: the proj config's first
    window radius widened to 3 m (the synthetic clouds are dense
    everywhere) with 20000 points a cloud; the full free config in bf16.
    ``step_hook(i)``, if given, runs before step i (1-based)."""
    import torch

    from i2pnet_tpu_torch import metrics as M
    from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
    from i2pnet_tpu_torch.models import I2PNet, I2PNetProj, init_flax_
    from i2pnet_tpu_torch.models.i2pnet import resolve_device
    from i2pnet_tpu_torch.train import create_train_state, make_train_step, make_train_step_proj

    device = resolve_device(device)
    if proj:
        cfg = I2PNetProjConfig.tiny() if tiny else I2PNetProjConfig()
        cfg = dataclasses.replace(cfg, down_conv_dis=(3.0,) + cfg.down_conv_dis[1:])
        points = 2048 if tiny else 20000
    else:
        cfg = I2PNetConfig.tiny() if tiny else I2PNetConfig()
        if not tiny:
            cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
        points = cfg.lidar_in_points
    if dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    model = (I2PNetProj if proj else I2PNet)(cfg, device=device)
    init_flax_(model, torch.Generator().manual_seed(0))
    step = make_train_step_proj(model, cfg) if proj else make_train_step(model, cfg)
    state = create_train_state(model, lr=1e-3, steps_per_epoch=1000)
    generator = torch.Generator(device).manual_seed(0)

    rng = np.random.default_rng(0)

    def draw():
        b = make_batch(rng, points, batch, img_h, img_w, device)
        if proj:
            b["raw_xyz"] = b["lidar"]  # the raw frame is the decalibrated frame
        return b

    draw()  # the JAX tool builds its variables on a first batch
    eval_batch = draw()
    init_E = np.tile(np.eye(3, 4, dtype=np.float32)[None], (batch, 1, 1))

    def report(tag):
        model.eval()
        with torch.inference_mode():
            b = eval_batch
            args = ((b["rgb"], b["lidar"], b["raw_xyz"], b["intrinsic"]) if proj
                    else (b["rgb"], b["lidar"], b["intrinsic"]))
            out3 = model(*args)["out3"].float().cpu().numpy()
        pred_E, gt_E = M.get_extrinsic(out3, b["decalib_q_gt"].cpu().numpy(),
                                       b["decalib_t_gt"].cpu().numpy(), init_E)
        rre, rte = M.rte_rre(pred_E, gt_E)
        print(f"{tag}: RRE {rre.mean():.2f} deg, RTE {rte.mean():.3f} m", flush=True)
        return float(rre.mean()), float(rte.mean())

    rre0, rte0 = report("step 0 (random init)")
    t0 = time.time()
    for i in range(1, steps + 1):
        if i % 10 == 1:  # fresh decalibrations, the same scene distribution
            train_batch = draw()
        if step_hook is not None:
            step_hook(i)
        m = step(state, train_batch, generator)
        if i % report_every == 0:
            report(f"step {i} (loss {float(m['loss']):.3f})")
    rre1, rte1 = report(f"final (train time {time.time() - t0:.0f}s)")
    return rre0, rte0, rre1, rte1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--proj", action="store_true",
                    help="projection model (large-range protocol shapes)")
    ap.add_argument("--img_h", type=int, default=160)
    ap.add_argument("--img_w", type=int, default=512)
    ap.add_argument("--report_every", type=int, default=50)
    ap.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                    help="override the compute dtype (default: bf16 for the full free-point "
                         "config, f32 otherwise)")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu")
    args = ap.parse_args(argv)
    rre0, rte0, rre1, rte1 = converge(args.steps, args.batch, args.tiny, args.proj, args.img_h,
                                      args.img_w, args.report_every, args.dtype, args.device)
    if not (rre1 < rre0 and rte1 < rte0):
        raise SystemExit("no improvement: learning is broken")
    print("CONVERGENCE OK: RRE %.2f->%.2f deg, RTE %.3f->%.3f m" % (rre0, rre1, rte0, rte1),
          flush=True)


if __name__ == "__main__":
    main()
