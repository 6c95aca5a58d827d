#!/usr/bin/env python3
"""Sequential demo renderer of the PyTorch / CUDA port (the twin of
``tools/render_demo.py``; ref evaluation_cmr_demo.py and the *_demo
loaders): walk a test split in order, run the model one frame at a time
(B=1) on ``--device`` (the card unless ``cpu``), and write each frame's
init/pred/gt projection panel as a PNG, the frames behind the reference's
demo videos. The model, its checkpoint and the split come from
``evaluate_torch.py``'s flags and factories (``cli.build``,
``cli.eval_split``). The proj family normalises by the current batch even at
eval, so its B=1 frame is normalised over itself, as in the JAX demo.

    python3 tools/render_demo_torch.py --dataset kd_cmr_snr --root_path /dataset \\
        --model_dir log/cmr --out demo_frames [--frames 50] [--heat] [--video demo.gif]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="kd_cmr_snr", choices=["kd_cmr_snr", "kd_corr_nolidar"])
    ap.add_argument("--network", default="i2pnet")
    ap.add_argument("--root_path", default="/dataset")
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--best", default="model_rotation_best")
    ap.add_argument("--out", default="demo_frames")
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--heat", action="store_true",
                    help="append a pred-vs-gt reprojection-error heat panel")
    ap.add_argument("--video", default=None, help="also stitch the frames into this mp4/gif")
    ap.add_argument("--fps", type=int, default=10)
    ap.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="cuda", help="the device the model runs on (cuda, or cpu)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Render the frames; returns {"frames": n, "forward_ms", "render_ms",
    "write_ms": a list each, one entry a frame (forward_ms up to out3 on the
    host), "out3": each frame's (7,) prediction}."""
    args = parse_args(argv)
    import torch

    import evaluate_torch
    from i2pnet_tpu_torch.cli import build, eval_split
    from i2pnet_tpu_torch.eval.visualize import (decalib_extrinsic, render_comparison,
                                                 render_error_heat, save_image, write_video)
    from i2pnet_tpu_torch.train.checkpoint import restore_inference_variables

    eval_args = evaluate_torch.parse_args(
        ["--dataset", args.dataset, "--network", args.network, "--root_path", args.root_path,
         "--model_dir", args.model_dir, "--best", args.best, "--seed", str(args.seed),
         "--compute_dtype", args.compute_dtype, "--device", args.device]
        + (["--tiny"] if args.tiny else []))
    model, cfg, proj = build(eval_args)
    model.load_state_dict(restore_inference_variables(args.model_dir, model, best=args.best),
                          strict=True)
    model.eval()
    device = next(model.parameters()).device
    test_ds = eval_split(eval_args, cfg)

    def forward(s):
        rgb, lidar, raw, intr, feats = (
            torch.from_numpy(np.asarray(s[k], np.float32))[None].to(device)
            for k in ("rgb", "lidar", "raw_point_xyz", "init_intrinsic", "lidar_feats"))
        with torch.inference_mode():
            if proj:
                out = model(rgb, lidar, raw, intr, lidar_feature=feats)
            else:
                out = model(rgb, lidar, intr, lidar_feature=feats, raw_xyz=raw)
            return out["out3"].float().cpu().numpy()

    os.makedirs(args.out, exist_ok=True)
    n = min(args.frames, len(test_ds))
    frames, times = [], {"forward_ms": [], "render_ms": [], "write_ms": [], "out3": []}
    for i in range(n):
        s = test_ds[i]
        t0 = time.perf_counter()
        out3 = forward(s)
        t1 = time.perf_counter()
        # the decalibrated cloud through the identity (the initial pose), the
        # predicted correction and the ground-truth correction
        rgb_u8 = np.clip(s["rgb"], 0, 255).astype(np.uint8)
        gt = np.concatenate([s["decalib_real_gt"], s["decalib_dual_gt"]])
        pred_E = decalib_extrinsic(out3[0, :4], out3[0, 4:])
        gt_E = decalib_extrinsic(gt[:4], gt[4:])
        panel = render_comparison(rgb_u8, s["lidar"], np.eye(3, 4, dtype=np.float32), pred_E,
                                  gt_E, s["init_intrinsic"])
        if args.heat:
            heat = render_error_heat(rgb_u8, s["lidar"], pred_E, gt_E, s["init_intrinsic"])
            panel = np.concatenate([panel, heat], axis=0)
        t2 = time.perf_counter()
        save_image(os.path.join(args.out, f"frame_{i:06d}.png"), panel)
        t3 = time.perf_counter()
        for key, a, b in (("forward_ms", t0, t1), ("render_ms", t1, t2), ("write_ms", t2, t3)):
            times[key].append((b - a) * 1e3)
        times["out3"].append(out3[0])
        if args.video:
            frames.append(panel)
    print(f"wrote {n} frames to {args.out}")
    if args.video and frames:
        print(f"wrote video {write_video(args.video, frames, fps=args.fps)}")
    return dict(frames=n, **times)


if __name__ == "__main__":
    main()
