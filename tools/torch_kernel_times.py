#!/usr/bin/env python3
"""Time the port's FPS and conv_dw kernels of one source tree, per call shape.

    python3 tools/torch_kernel_times.py [--tree DIR] [--label NAME]

Imports ``i2pnet_tpu_torch`` from DIR (default: this checkout), so that two
trees -- a change and its parent unpacked beside it -- can be timed in one
run on one card: parent, change, change, parent. It needs a CUDA device.

FPS: the four levels of the free path (B=8: 8192 -> 2048 -> 1024 -> 256 ->
64 points), each level's cloud the previous level's samples, the first
``chip_smoke.py``'s LiDAR cloud; at the tree's default thread count, and at
128, 256, 512 and 1024 threads a row where the tree's wrapper takes a count.
conv_dw: the 15 calls of the free train step (B=8, 384x1280, the encoder's
convs), random bf16 operands; beside ``torch.nn.grad.conv2d_weight``.
Each time: a CUDA graph of one call replayed, median of 5 after a warm-up.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys

REPEATS = 5
FPS_LEVELS = (2048, 1024, 256, 64)


def replay_ms(fn) -> float:
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    times = []
    for _ in range(REPEATS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def encoder_convs(B=8, H=384, W=1280):
    stages = ((3, (16, 16, 16, 16, 32), (2, 1, 1, 1, 2)),
              (32, (32, 32, 32, 32, 64), (2, 1, 1, 1, 2)),
              (64, (64, 64, 64, 64, 128), (1, 1, 1, 1, 2)))
    shapes = []
    for cin, channels, strides in stages:
        for cout, s in zip(channels, strides):
            shapes.append((B, H, W, cin, cout))
            H, W, cin = (H - 1) // s + 1, (W - 1) // s + 1, cout
    return shapes


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    from i2pnet_tpu_torch.ops import conv_train_cuda, fps_cuda

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    takes_threads = "threads" in inspect.signature(fps_cuda.fps_cuda).parameters
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-10, 10, size=(8, 8192, 3)).astype(np.float32)
    xyz[..., 2] += 20.0
    xyz = torch.from_numpy(xyz).to(dev)
    fps = []
    for npoint in FPS_LEVELS:
        row = {"n": xyz.shape[1], "npoint": npoint}
        for threads in ((0, 128, 256, 512, 1024) if takes_threads else (0,)):
            if threads and xyz.shape[1] > 32 * threads:
                continue
            call = (lambda t=threads: fps_cuda.fps_cuda(xyz, npoint, t)) if takes_threads else \
                (lambda: fps_cuda.fps_cuda(xyz, npoint))
            ms = replay_ms(call)
            row[f"ms_{threads or 'auto'}"] = ms
            row[f"us_per_step_{threads or 'auto'}"] = ms * 1e3 / npoint
        fps.append(row)
        idx = fps_cuda.fps_cuda(xyz, npoint)
        xyz = torch.gather(xyz, 1, idx[..., None].expand(-1, -1, 3)).contiguous()
    dw = []
    for B, H, W, cin, cout in encoder_convs():
        x = torch.randn(B, H, W, cin, device=dev).to(torch.bfloat16)
        g = torch.randn(B, H, W, cout, device=dev).to(torch.bfloat16)
        xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        dw.append({
            "shape": [B, H, W, cin, cout],
            "ms": replay_ms(lambda: conv_train_cuda.conv_dw_cuda(x, g)),
            "conv2d_weight_ms": replay_ms(lambda: torch.nn.grad.conv2d_weight(
                xn, (cout, cin, 3, 3), gn, padding=1)),
        })
    total = {"fps_ms": sum(r["ms_auto"] for r in fps), "dw_ms": sum(r["ms"] for r in dw),
             "conv2d_weight_ms": sum(r["conv2d_weight_ms"] for r in dw)}
    total["fps_us_per_step"] = total["fps_ms"] * 1e3 / sum(FPS_LEVELS)
    print(json.dumps({"label": args.label, "card": card, "total": total, "fps": fps, "dw": dw}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
