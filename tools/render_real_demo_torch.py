#!/usr/bin/env python3
"""Real-data visual demo of the PyTorch / CUDA port (the twin of
``tools/render_real_demo.py``; ref evaluation_vis.py "realloc" branch,
:283-293): walk real-rig frames (``sequences/<seq>/velodyne/<ts>.bin`` and
``images/<ts>.jpg``, one fixed rig intrinsic; ``data/realloc.py``) and
overlay the LiDAR projection under the init, predicted and ground-truth
extrinsics read from an evaluator's prediction.txt
(``eval/analysis.py`` ``parse_prediction_file``), the frames behind the
reference's real-world demo. The frames are decoded by cv2 or PIL
(``data/realloc.py`` ``read_image``), the panels written by zlib
(``eval/visualize.py`` ``save_image``):

    python3 tools/render_real_demo_torch.py --root /dataset/real_localize \\
        --pred log/run/prediction.txt --out real_demo [--frames 50] [--video demo.gif]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def render_real_demo(root: str, pred_path: str, out_dir: str, max_frames: int = 50,
                     video: str | None = None, fps: int = 10) -> int:
    """Render the per-frame init/pred/gt panels; returns the frame count."""
    from i2pnet_tpu_torch.data.realloc import RealLocVisDataset
    from i2pnet_tpu_torch.eval.analysis import parse_prediction_file
    from i2pnet_tpu_torch.eval.visualize import render_comparison, save_image, write_video

    ds = RealLocVisDataset(root)
    mats = parse_prediction_file(pred_path)
    n = min(len(ds), len(mats["pred"]), max_frames)
    os.makedirs(out_dir, exist_ok=True)
    frames = []
    for i in range(n):
        sample = ds[i]
        panel = render_comparison(
            sample["img"], sample["pcl"].astype(np.float32),
            mats["init"][i] if "init" in mats else mats["pred"][i], mats["pred"][i],
            mats["gt"][i] if "gt" in mats else mats["pred"][i], sample["K"])
        save_image(os.path.join(out_dir, f"{sample['seq']}_{sample['ts']}.png"), panel)
        frames.append(panel)
    if video and frames:
        write_video(os.path.join(out_dir, video), frames, fps=fps)
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default="/dataset/real_localize")
    ap.add_argument("--pred", required=True, help="an evaluator's prediction.txt")
    ap.add_argument("--out", default="real_demo")
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--video", default=None, help="mp4/gif file name")
    ap.add_argument("--fps", type=int, default=10)
    args = ap.parse_args(argv)
    n = render_real_demo(args.root, args.pred, args.out, args.frames, args.video, args.fps)
    print(f"rendered {n} real-data frames to {args.out}")
    return n


if __name__ == "__main__":
    main()
