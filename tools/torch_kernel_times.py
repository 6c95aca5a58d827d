#!/usr/bin/env python3
"""Time the port's FPS, conv_dw, encoder-block, cv1, train-conv, pool
(idx backward and forward, recompute backward, route) and window-select
kernels of one source tree, per call shape, and its KNN.

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
conv: kernel (a) at the calls of one free and one proj train step (B=8;
the forward of each of the 15 encoder convs, dx of the 14 whose input takes
a gradient), each beside ``F.conv2d`` or ``conv2d_input`` on the same
operands and its bound, with its max abs error against the plain version;
each step's calls also in one graph.
pool: kernel (d) (``bn_pool_bwd_cuda``) at the 15 calls of each step, on
the taps kernel (c) finds, beside its bound and
``max_pool2d_with_indices_backward`` on the same routing (a yardstick of the
routing's share, not the same function), and whether dz equals the plain
version bit for bit.
poolfwd: kernel (c) (``bn_pool_fwd_cuda``) and kernel (e)
(``bn_pool_fwd_notap_cuda``) at the 15 calls of each step, beside their
bounds and ``F.max_pool2d(..., return_indices=True)`` on the activated
tensor (a yardstick of the pool's share, not the same function: no affine,
no activation, int64 indices), and whether out and taps equal the plain
version bit for bit.
recompute: kernel (f) (``bn_pool_bwd_recompute_cuda``) at the 15 calls of
each step, on random bf16 operands, beside its bound and kernel (d) on the
taps kernel (c) finds for the same call, and whether dz equals the plain
version and (d)'s bit for bit.
route: the route kernel (``pool_route_cuda``) at the 15 pool calls of each
step's native chain (bf16, the chain's dtype under bf16 compute; argtap
from ``pool3_argtap`` of a random input), beside its bound and
``max_pool2d_with_indices_backward`` on the same routing, and whether dx
equals the plain version; the stride-1 and stride-2 calls summed apart.
select: the window select at the 5 calls of one proj eval forward
(``chip_smoke.py``'s model and inputs, the calls captured), each beside its
bound (this run's data) and whether m equals the plain version; then each
level's shape on a clustered grid, where every slot is valid and K is below
the count (the kernel's other branch).
knn: ``knn_point`` at the calls of one free eval forward (``chip_smoke.py``'s
model and inputs, B=8, 8192 points; the calls captured, the set
abstractions' and the cost volumes'), each alone and all in one graph,
and the whole forward in one graph: the KNN's share of the forward.
sweep: kernel (a) at each distinct call shape of the free step on other
launch plans (``conv3x3_launch_plan``; trees that have it), the plan's
channel tile and slab width varied, and the default plan's rows cut for
1, 2 and 4 waves of blocks.
Each time: a CUDA graph of one call replayed, median of 5 after a warm-up;
for poolfwd, recompute, route and select also ``ms_x10``, ten calls in one
graph, per call.
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
BF16_FLOPS = 989e12
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


def in_graph_ms(fn, n=10) -> float:
    """fn's time a call with n calls in one graph: the graph's own launch
    spread over n, each kernel's launch inside a graph kept (as in a step's
    graph)."""
    return replay_ms(lambda: [fn() for _ in range(n)]) / n


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


def step_convs(B, H, W):
    """(B, H, W, cin, cout, stride, dx) of each encoder conv of a train step:
    dx where the conv's input takes a gradient (every conv but the first)."""
    return [(*c, i > 0) for i, c in enumerate(encoder_convs(B, H, W))]


def bound_ms(nbytes, flops):
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3


def conv_operands(torch, dev, gen, B, h, w, cin, cout):
    x = torch.randn(B, h, w, cin, device=dev, generator=gen).to(torch.bfloat16)
    wt = (0.3 * torch.randn(cout, 3, 3, cin, device=dev, generator=gen)).to(torch.bfloat16)
    bias = torch.randn(cout, device=dev, generator=gen)
    return x, wt, bias


def time_conv(torch, ct, dev, H, W):
    """Kernel (a) at each forward and dx call of a train step at H x W."""
    import torch.nn.functional as F

    gen = torch.Generator(dev).manual_seed(0)
    rows, fns = [], {"fwd": [], "dx": []}
    for B, h, w, cin, cout, s, dx in step_convs(8, H, W):
        calls = [("fwd", cin, cout)] + ([("dx", cout, cin)] if dx else [])
        for kind, ci, co in calls:  # dx: the conv of the cotangent (co = the block's cin)
            x, wt, bias = conv_operands(torch, dev, gen, B, h, w, ci, co)
            if kind == "fwd":
                fn = lambda x=x, wt=wt, b=bias: ct.conv_fwd_cuda(x, wt, b)
                ref = ct.conv_fwd_plain(x, wt, bias)
                xn, wn, bn = x.permute(0, 3, 1, 2), wt.permute(0, 3, 1, 2), bias.to(torch.bfloat16)
                lib = lambda xn=xn, wn=wn, bn=bn: F.conv2d(xn, wn, bn, padding=1)
                nbytes = sum(t.numel() * t.element_size() for t in (x, wt, bias)) + B * h * w * co * 2
            else:
                fn = lambda x=x, wt=wt: ct.conv_dx_cuda(x, wt)
                ref = ct.conv_dx_plain(x, wt)
                # dx = conv2d_input of the forward conv whose weights wt flips
                gn, wf = x.permute(0, 3, 1, 2), wt.flip(1, 2).permute(3, 0, 1, 2)
                lib = lambda gn=gn, wf=wf, B=B, h=h, w=w, co=co: torch.nn.grad.conv2d_input(
                    (B, co, h, w), wf, gn, padding=1)
                nbytes = sum(t.numel() * t.element_size() for t in (x, wt)) + B * h * w * co * 2
            err = float((fn().float() - ref.float()).abs().max())
            row = {"kind": kind, "shape": [B, h, w, ci, co], "ms": replay_ms(fn),
                   "library_ms": replay_ms(lib),
                   "bound_ms": bound_ms(nbytes, 2.0 * B * h * w * 9 * ci * co),
                   "max_abs_err": err, "bar": 0.01 * max(float(ref.float().abs().max()), 1.0)}
            rows.append(row)
            fns[kind].append(fn)
    return rows, fns


def route_indices(torch, taps, g, stride, H, W):
    """max_pool2d_with_indices_backward's operands for the routing of taps:
    NCHW views of g and a stand-in input, and the flat first-max index."""
    B, Ho, Wo, C = g.shape
    tap = taps.long()
    oh = torch.arange(Ho, device=g.device)[None, :, None, None]
    ow = torch.arange(Wo, device=g.device)[None, None, :, None]
    idx = (oh * stride + tap // 3 - 1) * W + ow * stride + tap % 3 - 1
    x = torch.empty(B, H, W, C, dtype=g.dtype, device=g.device)
    return g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), idx.permute(0, 3, 1, 2)


def time_pool(torch, ct, dev, H, W):
    """Kernel (d) at each bn_pool call of a train step at H x W."""
    gen = torch.Generator(dev).manual_seed(0)
    rows, fns = [], []
    for B, h, w, _, cout, s, _ in step_convs(8, H, W):
        y = torch.randn(B, h, w, cout, device=dev, generator=gen).to(torch.bfloat16)
        sc = torch.rand(cout, device=dev, generator=gen) + 0.5
        sh = 0.1 * torch.randn(cout, device=dev, generator=gen)
        _, taps = ct.bn_pool_fwd_cuda(y, sc, sh, s)
        g = torch.randn(*taps.shape, device=dev, generator=gen).to(torch.bfloat16)
        fn = lambda y=y, sc=sc, sh=sh, taps=taps, g=g, s=s: ct.bn_pool_bwd_cuda(y, sc, sh, taps, g, s)
        exact = bool(torch.equal(fn(), ct.bn_pool_bwd_plain(y, sc, sh, taps, g, s)))
        gn, xn, idx = route_indices(torch, taps, g, s, h, w)
        lib = lambda gn=gn, xn=xn, idx=idx, s=s: torch.ops.aten.max_pool2d_with_indices_backward(
            gn, xn, [3, 3], [s, s], [1, 1], [1, 1], False, idx)
        nbytes = (sum(t.numel() * t.element_size() for t in (y, sc, sh, taps, g))
                  + y.numel() * 4)
        rows.append({"shape": [B, h, w, cout, s], "ms": replay_ms(fn), "route_yardstick_ms":
                     replay_ms(lib), "bound_ms": bound_ms(nbytes, 0.0), "exact": exact})
        fns.append(fn)
    return rows, fns


def time_recompute(torch, ct, dev, H, W):
    """Kernel (f) at each bn_pool call of a train step at H x W, beside (d)
    on (c)'s taps for the same call."""
    gen = torch.Generator(dev).manual_seed(0)
    rows, fns = [], {"f": [], "d": []}
    for B, h, w, _, cout, s, _ in step_convs(8, H, W):
        y = torch.randn(B, h, w, cout, device=dev, generator=gen).to(torch.bfloat16)
        sc = torch.rand(cout, device=dev, generator=gen) + 0.5
        sh = 0.1 * torch.randn(cout, device=dev, generator=gen)
        _, taps = ct.bn_pool_fwd_cuda(y, sc, sh, s)
        g = torch.randn(*taps.shape, device=dev, generator=gen).to(torch.bfloat16)
        f = lambda y=y, sc=sc, sh=sh, g=g, s=s: ct.bn_pool_bwd_recompute_cuda(y, sc, sh, g, s)
        d = lambda y=y, sc=sc, sh=sh, taps=taps, g=g, s=s: ct.bn_pool_bwd_cuda(y, sc, sh, taps, g, s)
        dz = f()
        exact = torch.equal(dz, ct.bn_pool_bwd_recompute_plain(y, sc, sh, g, s))
        nbytes = sum(t.numel() * t.element_size() for t in (y, sc, sh, g, dz))
        rows.append({"shape": [B, h, w, cout, s], "ms": replay_ms(f), "ms_x10": in_graph_ms(f),
                     "idx_bwd_ms": replay_ms(d), "bound_ms": bound_ms(nbytes, 0.0),
                     "exact": bool(exact), "equals_idx": bool(torch.equal(dz, d()))})
        fns["f"].append(f)
        fns["d"].append(d)
    return rows, fns


def time_route(torch, pool_route_cuda, dev, H, W):
    """The route kernel at each pool call of a train step's native chain at
    H x W (bf16, the chain's dtype under bf16 compute), beside
    max_pool2d_with_indices_backward on the same routing."""
    import torch.nn.functional as F

    gen = torch.Generator(dev).manual_seed(0)
    rows, fns = [], []
    for B, h, w, _, cout, s, _ in step_convs(8, H, W):
        x = torch.randn(B, h, w, cout, device=dev, generator=gen).to(torch.bfloat16)
        y = F.max_pool2d(x.float().permute(0, 3, 1, 2), 3, s, 1).permute(0, 2, 3, 1)
        argtap = pool_route_cuda.pool3_argtap(x, y.to(torch.bfloat16), s)
        ct_ = torch.randn(*argtap.shape, device=dev, generator=gen).to(torch.bfloat16)
        fn = lambda a=argtap, c=ct_, s=s: pool_route_cuda.pool_route_cuda(a, c, s)
        dx = fn()
        exact = torch.equal(dx, pool_route_cuda.pool_route_plain(argtap, ct_, s))
        gn, xn, idx = route_indices(torch, argtap, ct_, s, h, w)
        lib = lambda gn=gn, xn=xn, idx=idx, s=s: torch.ops.aten.max_pool2d_with_indices_backward(
            gn, xn, [3, 3], [s, s], [1, 1], [1, 1], False, idx)
        nbytes = sum(t.numel() * t.element_size() for t in (argtap, ct_, dx))
        rows.append({"shape": [B, h, w, cout, s], "ms": replay_ms(fn), "ms_x10": in_graph_ms(fn),
                     "library_ms": replay_ms(lib), "bound_ms": bound_ms(nbytes, 0.0),
                     "exact": bool(exact)})
        fns.append(fn)
    return rows, fns


def time_pool_fwd(torch, ct, dev, H, W):
    """Kernels (c) and (e) at each bn_pool call of a train step at H x W."""
    import torch.nn.functional as F

    gen = torch.Generator(dev).manual_seed(0)
    rows, fns = [], {"c": [], "e": []}
    for B, h, w, _, cout, s, _ in step_convs(8, H, W):
        y = torch.randn(B, h, w, cout, device=dev, generator=gen).to(torch.bfloat16)
        sc = torch.rand(cout, device=dev, generator=gen) + 0.5
        sh = 0.1 * torch.randn(cout, device=dev, generator=gen)
        c = lambda y=y, sc=sc, sh=sh, s=s: ct.bn_pool_fwd_cuda(y, sc, sh, s)
        e = lambda y=y, sc=sc, sh=sh, s=s: ct.bn_pool_fwd_notap_cuda(y, sc, sh, s)
        out, taps = c()
        ref_out, ref_taps = ct.bn_pool_fwd_plain(y, sc, sh, s)
        exact = (torch.equal(out, ref_out) and torch.equal(taps, ref_taps)
                 and torch.equal(e(), ref_out))
        z = y.float() * sc + sh
        a = torch.where(z >= 0, z, 0.1 * z).to(torch.bfloat16).permute(0, 3, 1, 2)
        lib = lambda a=a, s=s: F.max_pool2d(a, 3, s, 1, return_indices=True)
        nbytes = sum(t.numel() * t.element_size() for t in (y, sc, sh, out))
        rows.append({"shape": [B, h, w, cout, s], "ms": replay_ms(c), "notap_ms": replay_ms(e),
                     "ms_x10": in_graph_ms(c), "notap_ms_x10": in_graph_ms(e),
                     "pool_yardstick_ms": replay_ms(lib),
                     "bound_ms": bound_ms(nbytes + taps.numel(), 0.0),
                     "notap_bound_ms": bound_ms(nbytes, 0.0), "exact": bool(exact)})
        fns["c"].append(c)
        fns["e"].append(e)
    return rows, fns


def time_select(torch, dev):
    """The window select at the calls of one proj eval forward, and each
    level's shape on a clustered grid (every slot valid)."""
    import dataclasses

    import numpy as np

    # this checkout's chip_smoke.py (the package is already the tree's)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import Capture, make_proj_inputs, select_ops
    from i2pnet_tpu_torch.config import I2PNetProjConfig
    from i2pnet_tpu_torch.models import I2PNetProj, init_random_
    from i2pnet_tpu_torch.ops import select_cuda

    cfg = dataclasses.replace(I2PNetProjConfig(), compute_dtype="bfloat16")
    model = init_random_(I2PNetProj(cfg), torch.Generator().manual_seed(0)).eval()
    with torch.no_grad(), Capture(select_cuda, "selection_multiplicity_cuda") as cap:
        model(*make_proj_inputs(dev))
    del model
    calls = [a for a, _ in cap.calls]
    rng = np.random.default_rng(0)
    for a in list(calls[:4]):  # every slot valid: the clustered grid at each level's shape
        xyz = 1.0 + 0.05 * rng.random(a[0].shape)
        calls.append((torch.from_numpy(xyz.astype(np.float32)).to(dev), *a[1:]))
    rows, fns = [], []
    for k, a in enumerate(calls):
        fn = lambda a=a: select_cuda.selection_multiplicity_cuda(*a)
        m = fn()
        exact = torch.equal(m, select_cuda.selection_multiplicity_plain(*a))
        nbytes = a[0].numel() * 4 + m.numel() * 4
        ops = select_ops(a, m)
        S = a[4][0] * a[4][1]
        hits = (m[..., :S] > 0).sum(-1).float()
        rows.append({"grid": "forward" if k < len(cap.calls) else "clustered",
                     "shape": [*a[0].shape[:3], a[1], a[2], *a[3], *a[4], a[5]],
                     "ms": replay_ms(fn), "ms_x10": in_graph_ms(fn),
                     "bound_ms": bound_ms(nbytes, 0.0),
                     "ops_ms": ops / 67e12 * 1e3, "exact": bool(exact),
                     # queries whose centre is invalid (no hit, all K on the
                     # sentinel), and the mean and largest hits a query
                     "no_hit_share": float((hits == 0).float().mean()),
                     "mean_hits": float(hits.mean()), "max_hits": int(hits.max())})
        if k < len(cap.calls):
            fns.append(fn)
    return rows, fns


def time_knn(torch, dev):
    """The KNN calls of one free eval forward, each alone and all in one
    graph, and the forward in one graph."""
    import dataclasses

    # this checkout's chip_smoke.py (the package is already the tree's)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import Capture, make_inputs
    from i2pnet_tpu_torch.config import I2PNetConfig
    from i2pnet_tpu_torch.models import I2PNet, init_random_
    from i2pnet_tpu_torch.nn import costvolume
    from i2pnet_tpu_torch.ops import pointops

    cfg = dataclasses.replace(I2PNetConfig(), compute_dtype="bfloat16")
    model = init_random_(I2PNet(cfg), torch.Generator().manual_seed(0)).eval()
    inputs = make_inputs(cfg, dev)
    with torch.no_grad():
        with Capture(pointops, "knn_point") as sa, Capture(costvolume, "knn_point") as cv:
            model(*inputs)
        calls = [a for a, _ in sa.calls + cv.calls]
        rows = [{"k": k, "xyz": list(xyz.shape), "queries": list(q.shape),
                 "ms": replay_ms(lambda k=k, xyz=xyz, q=q: pointops.knn_point(k, xyz, q))}
                for k, xyz, q in calls]
        knn_ms = replay_ms(lambda: [pointops.knn_point(*a) for a in calls])
        forward_ms = replay_ms(lambda: model(*inputs))
    return rows, knn_ms, forward_ms


def sweep_conv(torch, ct, dev):
    """Kernel (a) on other launch plans at each distinct call shape of the
    free step: each channel tile that divides cout and each slab width
    whose layout fits, the rows cut as the default plan cuts them."""
    lib = ct._conv_lib()
    gen = torch.Generator(dev).manual_seed(0)
    shapes = []
    for B, h, w, cin, cout, s, dx in step_convs(8, 384, 1280):
        shapes.append((B, h, w, cin, cout))
        if dx:
            shapes.append((B, h, w, cout, cin))
    out = []
    for B, h, w, ci, co in sorted(set(shapes)):
        x, wt, bias = conv_operands(torch, dev, gen, B, h, w, ci, co)
        y = torch.empty(B, h, w, co, dtype=torch.bfloat16, device=dev)
        default = ct._conv_plan(B, h, w, ci, co)
        row = {"shape": [B, h, w, ci, co], "default": list(default),
               "default_ms": replay_ms(lambda: ct.conv_fwd_cuda(x, wt, bias)), "plans": []}
        for d in [d for d in range(min(co, 64) // 8 * 8, 7, -8) if co % d == 0]:
            for mt_cap in range(8, 0, -1):
                slabs = -(-w // (16 * mt_cap))
                sw = -(-w // slabs)
                mt = -(-sw // 16)
                smem = ct._conv_smem(ci, d, mt)
                if smem > ct._CONV_SMEM_MAX or any(
                        (p["co_t"], p["mt"]) == (d, mt) for p in row["plans"]):
                    continue
                strips = B * slabs * (co // d)
                per_sm = min(3, ct._SM_SMEM // (smem + ct._BLOCK_RESERVE))
                maxrc = -(-h // 4)
                rc = max(1, min(maxrc, per_sm * 132 // strips))
                rows = -(-(-(-h // rc)) // 4) * 4
                args = (ct._build.ptr(x), ct._build.ptr(wt), ct._build.ptr(bias),
                        ct._build.ptr(y), B, h, w, ci, co, d, mt, sw, slabs, rows, -(-h // rows))

                def run(args=args):
                    ct._build.check(lib, lib.conv3x3_launch_plan(*args, ct._build.stream_of(x)),
                                    "conv3x3_launch_plan")
                run()
                err = float((y.float() - ct.conv_fwd_plain(x, wt, bias).float()).abs().max())
                row["plans"].append({"co_t": d, "mt": mt, "rows": rows, "per_sm": per_sm,
                                     "ms": replay_ms(run), "max_abs_err": err})
        # the default slab and tile, the rows cut for 1, 2 and 4 waves
        d, mt, sw, slabs = default.co_t, default.mt, default.sw, default.slabs
        row["waves"] = []
        for waves in (1, 2, 4):
            rows = max(4, -(-(-(-default.rows // waves)) // 4) * 4)
            args = (ct._build.ptr(x), ct._build.ptr(wt), ct._build.ptr(bias), ct._build.ptr(y),
                    B, h, w, ci, co, d, mt, sw, slabs, rows, -(-h // rows))

            def run(args=args):
                ct._build.check(lib, lib.conv3x3_launch_plan(*args, ct._build.stream_of(x)),
                                "conv3x3_launch_plan")
            row["waves"].append({"waves": waves, "rows": rows, "ms": replay_ms(run)})
        out.append(row)
    return out


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
    ap.add_argument("--only", default="fps,dw,block,cv1,conv,pool,poolfwd,select",
                    help="comma-separated parts to time (fps, dw, block, cv1, conv, pool, "
                         "poolfwd, recompute, route, select, knn, sweep)")
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
    for key, (H, W) in (("free", (384, 1280)), ("proj", (160, 512))):
        if "recompute" in parts:
            rows, fns = time_recompute(torch, conv_train_cuda, dev, H, W)
            result[f"recompute_{key}"] = rows
            for col in ("ms", "ms_x10", "idx_bwd_ms", "bound_ms"):
                total[f"recompute_{key}_{col}"] = sum(r[col] for r in rows)
            for kind, kfns in fns.items():
                total[f"recompute_{key}_{kind}_one_graph_ms"] = replay_ms(
                    lambda: [f() for f in kfns])
            total[f"recompute_{key}_exact"] = all(r["exact"] and r["equals_idx"] for r in rows)
        if "route" in parts:
            from i2pnet_tpu_torch.ops import pool_route_cuda

            rows, fns = time_route(torch, pool_route_cuda, dev, H, W)
            result[f"route_{key}"] = rows
            for stride in (1, 2):
                sel = [r for r in rows if r["shape"][4] == stride]
                for col in ("ms", "ms_x10", "library_ms", "bound_ms"):
                    total[f"route_{key}_s{stride}_{col}"] = sum(r[col] for r in sel)
                sel_fns = [f for f, r in zip(fns, rows) if r["shape"][4] == stride]
                total[f"route_{key}_s{stride}_one_graph_ms"] = replay_ms(
                    lambda: [f() for f in sel_fns])
            total[f"route_{key}_exact"] = all(r["exact"] for r in rows)
        if "conv" in parts:
            rows, fns = time_conv(torch, conv_train_cuda, dev, H, W)
            result[f"conv_{key}"] = rows
            for kind in ("fwd", "dx"):
                sel = [r for r in rows if r["kind"] == kind]
                for col in ("ms", "library_ms", "bound_ms"):
                    total[f"conv_{kind}_{key}_{col}"] = sum(r[col] for r in sel)
                total[f"conv_{kind}_{key}_one_graph_ms"] = replay_ms(lambda: [f() for f in fns[kind]])
            total[f"conv_{key}_within_bar"] = all(r["max_abs_err"] <= r["bar"] for r in rows)
        if "pool" in parts:
            rows, fns = time_pool(torch, conv_train_cuda, dev, H, W)
            result[f"pool_bwd_{key}"] = rows
            for col in ("ms", "route_yardstick_ms", "bound_ms"):
                total[f"pool_bwd_{key}_{col}"] = sum(r[col] for r in rows)
            total[f"pool_bwd_{key}_one_graph_ms"] = replay_ms(lambda: [f() for f in fns])
            total[f"pool_bwd_{key}_exact"] = all(r["exact"] for r in rows)
        if "poolfwd" in parts:
            rows, fns = time_pool_fwd(torch, conv_train_cuda, dev, H, W)
            result[f"pool_fwd_{key}"] = rows
            for col in ("ms", "notap_ms", "ms_x10", "notap_ms_x10", "pool_yardstick_ms", "bound_ms",
                        "notap_bound_ms"):
                total[f"pool_fwd_{key}_{col}"] = sum(r[col] for r in rows)
            for kind, kfns in fns.items():
                total[f"pool_fwd_{key}_{kind}_one_graph_ms"] = replay_ms(
                    lambda: [f() for f in kfns])
            total[f"pool_fwd_{key}_exact"] = all(r["exact"] for r in rows)
    if "select" in parts:
        rows, fns = time_select(torch, dev)
        result["select"] = rows
        fwd = [r for r in rows if r["grid"] == "forward"]
        for col in ("ms", "ms_x10", "bound_ms", "ops_ms"):
            total[f"select_forward_{col}"] = sum(r[col] for r in fwd)
        total["select_forward_one_graph_ms"] = replay_ms(lambda: [f() for f in fns])
        total["select_exact"] = all(r["exact"] for r in rows)
    if "knn" in parts:
        result["knn"], total["knn_forward_one_graph_ms"], total["free_forward_one_graph_ms"] = \
            time_knn(torch, dev)
    if "sweep" in parts and hasattr(conv_train_cuda, "_conv_plan"):
        result["conv_sweep"] = sweep_conv(torch, conv_train_cuda, dev)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
