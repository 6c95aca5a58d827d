#!/usr/bin/env python3
"""Time the port's FPS, conv_dw, encoder-block and cv1 kernels of one source
tree, per call shape.

    python3 tools/torch_kernel_times.py [--tree DIR] [--label NAME] [--only PART,...]

Imports ``i2pnet_tpu_torch`` from DIR (default: this checkout), so that two
trees -- a change and its parent unpacked beside it -- can be timed in one
run on one card: parent, change, change, parent. It needs a CUDA device.

FPS: the four levels of the free path (B=8: 8192 -> 2048 -> 1024 -> 256 ->
64 points), each level's cloud the previous level's samples, the first
``chip_smoke.py``'s LiDAR cloud; at the tree's default thread count, and at
128, 256, 512 and 1024 threads a row where the tree's wrapper takes a count.
conv_dw: the 15 calls of the free train step (B=8, 384x1280, the encoder's
convs), random bf16 operands; beside ``torch.nn.grad.conv2d_weight``.
block: the eval encoder block (``conv_block_cuda``) at the 15 calls of the
free forward (B=8, 384x1280) and of the proj forward (B=8, 160x512), each
beside ``F.conv2d`` (bf16, channels_last) and kernel (a) ``conv_fwd_cuda``
on the conv alone -- yardsticks of the conv's share, not the same function
-- with its byte bound and its max abs error against ``conv_block_plain``;
the 15 calls also in one graph, as ``chip_smoke.py`` times a forward's.
cv1: at B=8, N=256, K=480, C=128 (the shipped widths), with its TFLOP/s and
its max abs error against ``cv1_plain``.
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
HBM_BYTES_PER_S = 3.35e12
STAGES = ((3, (16, 16, 16, 16, 32), (2, 1, 1, 1, 2)),
          (32, (32, 32, 32, 32, 64), (2, 1, 1, 1, 2)),
          (64, (64, 64, 64, 64, 128), (1, 1, 1, 1, 2)))
# cv1 at the shipped widths: B, N, K, C, H1, H2, H3, E, G1 (G2 = H3)
CV1_SHAPE = (8, 256, 480, 128, 128, 64, 64, 64, 128)


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
    """(B, H, W, cin, cout, stride) of each encoder block's conv input."""
    shapes = []
    for cin, channels, strides in STAGES:
        for cout, s in zip(channels, strides):
            shapes.append((B, H, W, cin, cout, s))
            H, W, cin = (H - 1) // s + 1, (W - 1) // s + 1, cout
    return shapes


def time_fps(torch, fps_cuda, dev):
    import numpy as np

    takes_threads = "threads" in inspect.signature(fps_cuda.fps_cuda).parameters
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
    return fps


def time_dw(torch, conv_train_cuda, dev):
    dw = []
    for B, H, W, cin, cout, _ in encoder_convs():
        x = torch.randn(B, H, W, cin, device=dev).to(torch.bfloat16)
        g = torch.randn(B, H, W, cout, device=dev).to(torch.bfloat16)
        xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        dw.append({
            "shape": [B, H, W, cin, cout],
            "ms": replay_ms(lambda: conv_train_cuda.conv_dw_cuda(x, g)),
            "conv2d_weight_ms": replay_ms(lambda: torch.nn.grad.conv2d_weight(
                xn, (cout, cin, 3, 3), gn, padding=1)),
        })
    return dw


def time_blocks(torch, conv_cuda, conv_train_cuda, dev, H, W):
    """Each encoder-block call of a forward at an H x W image: the kernel,
    F.conv2d and kernel (a) on its conv, its byte bound and its error."""
    import torch.nn.functional as F

    gen = torch.Generator(dev).manual_seed(0)
    rows, calls = [], {"ms": [], "conv2d_ms": [], "conv_fwd_ms": []}
    for B, h, w, cin, cout, s in encoder_convs(8, H, W):
        x = torch.randn(B, h, w, cin, device=dev, generator=gen).to(torch.bfloat16)
        wt = (0.3 * torch.randn(3, 3, cin, cout, device=dev, generator=gen)).to(torch.bfloat16)
        scale = torch.randn(cout, device=dev, generator=gen)
        shift = torch.randn(cout, device=dev, generator=gen)
        out = conv_cuda.conv_block_cuda(x, wt, scale, shift, s)
        ref = conv_cuda.conv_block_plain(x, wt, scale, shift, s)
        err = float((out.float() - ref.float()).abs().max())
        w_ohwi = wt.permute(3, 0, 1, 2).contiguous()
        bias = torch.zeros(cout, device=dev)
        xn = x.permute(0, 3, 1, 2)  # channels_last NCHW view
        wn = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        nbytes = sum(t.numel() * t.element_size() for t in (x, wt, scale, shift, out))
        fns = {
            "ms": lambda x=x, wt=wt, sc=scale, sh=shift, s=s: conv_cuda.conv_block_cuda(
                x, wt, sc, sh, s),
            "conv2d_ms": lambda xn=xn, wn=wn: F.conv2d(xn, wn, padding=1),
            "conv_fwd_ms": lambda x=x, w=w_ohwi, b=bias: conv_train_cuda.conv_fwd_cuda(x, w, b),
        }
        row = {"shape": [B, h, w, cin, cout, s]}
        for col, fn in fns.items():
            row[col] = replay_ms(fn)
            calls[col].append(fn)
        row.update(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, max_abs_err=err,
                   bar=0.01 * max(float(ref.float().abs().max()), 1.0))
        rows.append(row)
    return rows, calls


def time_cv1(torch, cv_cuda, dev):
    import numpy as np

    B, N, K, C, H1, H2, H3, E, G1 = CV1_SHAPE
    rng = np.random.default_rng(0)

    def t(*shape, dtype=torch.float32, s=1.0):
        return torch.from_numpy((s * rng.normal(size=shape)).astype(np.float32)).to(dev, dtype)

    bf = torch.bfloat16
    ops = (t(B, N, C, dtype=bf), t(B, N, H1), t(B, N, E), t(B, K, C, dtype=bf), t(B, K, H1),
           t(B, K, E), t(C, H1, dtype=bf, s=C**-0.5), t(H1, H2, dtype=bf, s=H1**-0.5), t(H2),
           t(H2, H3, dtype=bf, s=H2**-0.5), t(H3), t(E, G1, dtype=bf, s=E**-0.5),
           t(H3, G1, dtype=bf, s=H3**-0.5), t(G1), t(G1, H3, dtype=bf, s=G1**-0.5), t(H3))
    err = float((cv_cuda.cv1_cuda(*ops) - cv_cuda.cv1_plain(*ops)).abs().max())
    ms = replay_ms(lambda: cv_cuda.cv1_cuda(*ops))
    flops = 2.0 * B * N * K * (C * H1 + H1 * H2 + H2 * H3 + E * G1 + H3 * G1 + G1 * H3)
    return {"shape": list(CV1_SHAPE), "ms": ms, "tflops": flops / ms / 1e9, "max_abs_err": err}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--only", default="fps,dw,block,cv1",
                    help="comma-separated parts to time (fps, dw, block, cv1)")
    args = ap.parse_args()
    parts = set(args.only.split(","))
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    from i2pnet_tpu_torch.ops import conv_cuda, conv_train_cuda, cv_cuda, fps_cuda

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    torch.manual_seed(0)
    result = {"label": args.label, "card": card, "total": {}}
    total = result["total"]
    if "fps" in parts:
        result["fps"] = time_fps(torch, fps_cuda, dev)
        total["fps_ms"] = sum(r["ms_auto"] for r in result["fps"])
        total["fps_us_per_step"] = total["fps_ms"] * 1e3 / sum(FPS_LEVELS)
    if "dw" in parts:
        result["dw"] = time_dw(torch, conv_train_cuda, dev)
        total["dw_ms"] = sum(r["ms"] for r in result["dw"])
        total["conv2d_weight_ms"] = sum(r["conv2d_weight_ms"] for r in result["dw"])
    if "block" in parts:
        for key, (H, W) in (("block_free", (384, 1280)), ("block_proj", (160, 512))):
            rows, calls = time_blocks(torch, conv_cuda, conv_train_cuda, dev, H, W)
            result[key] = rows
            for col in ("ms", "conv2d_ms", "conv_fwd_ms", "bound_ms"):
                total[f"{key}_{col}"] = sum(r[col] for r in rows)
            # the 15 calls in one graph, as chip_smoke.py times a forward's
            for col, fns in calls.items():
                total[f"{key}_{col}_one_graph"] = replay_ms(lambda: [f() for f in fns])
            total[f"{key}_within_bar"] = all(r["max_abs_err"] <= r["bar"] for r in rows)
    if "cv1" in parts:
        result["cv1"] = time_cv1(torch, cv_cuda, dev)
        total["cv1_ms"] = result["cv1"]["ms"]
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
