#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``i2pnet_tpu_torch``).

Drives the port's four paths on one CUDA card with random weights from a
seeded ``torch.Generator``, at the shapes ``bench.py`` times: the
free-point I2PNet eval forward and the free-point train step (forward in
train mode with dropout, loss, backward, Adam), both with the shipped
config in bf16 at B=8, a 384x1280 image and 8192 LiDAR points; and the
projection-family I2PNetProj eval forward and train step, the shipped proj
config in bf16 at B=8, a 160x512 image and 150,000 raw points a row
(120,000 real, the tail zero), projected to a 64x1800 range image; then the
evaluation entry point, both families' 2-stage cascades through
``evaluate_torch.py`` and ``Evaluator`` at the same shapes; then the
training entry point, ``train_torch.py`` and the ``Trainer``, and a short
convergence run; then the online-calibration model and the projection-mask
and option branches; then the vehicle-localisation protocols (KITTI
odometry small-range, nuScenes small- and large-range) through their
loaders and entry points; then what a user runs around the model: the
reference-checkpoint bridge, the visual outputs and the offline dataset
builders. Phases, each raising on failure:

1. build every CUDA kernel library from ``i2pnet_tpu_torch/csrc`` (one
   nvcc per source, all at once) and print the card's name and power limit;
2. eval: run the forward; check out3/out4 (finite, unit quaternions, a
   second forward identical) and the kernels' launches in one forward
   (FPS 4, encoder block 15, cv1 1);
3. hold every kernel call of that forward against the kernel's plain
   PyTorch version on the same inputs (FPS exact; encoder block within
   0.01 * max(|ref|, 1); cv1 within 5e-3), TF32 off;
4. time the forward (median of 3 windows of 20 iterations, CUDA events),
   the forward replayed as a CUDA graph, and each kernel's launches of one
   forward against the plain version's, both replayed as CUDA graphs; FPS
   also per level (each call of the forward), in us per step, at the
   launcher's thread count and at 128, 256, 512 and 1024 threads a row;
5. train: one step with every kernel call captured; check the launches in
   one step (conv fwd 15, conv dx 14, conv dw 15, bn_pool fwd 15, bn_pool
   bwd 15, FPS 4, the eval kernels 0), a finite loss, that sx, sq and every
   parameter moved, every BatchNorm's running statistics moved (one encoder
   and one pointwise BatchNorm by flax's momentum rule), and that a second
   run from the same seeds gives a bit-identical first-step loss;
6. hold every train kernel call of that step against its plain version:
   conv fwd and dx within 0.01 * max(|ref|, 1), dw within 2e-3 * max|ref|
   and bit-identical when repeated, bn_pool out, taps and dz exactly;
7. time the train step (median of 3 windows of 20 steps) and each train
   kernel's launches of one step by graph replay, beside its plain version
   and a PyTorch library call for the same function where one exists; dw
   also per call shape, beside ``conv2d_weight`` and its bound; every
   conv fwd and dx call alone beside ``F.conv2d`` / ``conv2d_input`` on the
   same operands and its bound (alone, and ten in one graph, which spreads
   the graph's own launch), every bn_pool fwd call beside its bound and
   ``F.max_pool2d(..., return_indices=True)`` on the activated tensor, every
   bn_pool bwd call beside its bound and ``max_pool2d_with_indices_backward``
   on the same routing (the two last yardsticks, not the same function);
8. proj eval: run the forward; check out3/out4 (finite, unit quaternions,
   a second forward identical) and the launches in one forward (select 5,
   dense level 35, encoder block 15, FPS 0, cv1 0);
9. hold every select call of that forward against its plain version
   exactly, and every dense level pass and encoder-block call at the proj
   image's shapes within 0.01 * max(|ref|, 1);
10. time the proj forward (median of 3 windows of 20) and under CUDA-graph
   replay (which also proves it has no host synchronisation), the select
   kernel's and the dense level kernel's launches of one forward by graph
   replay beside their plain versions and bounds, and each select call
   alone (and ten in one graph);
11. proj train, the default pool backward (idx): one step (identity
   decalibration, dropout on, Adam); check the launches (conv fwd 15, dx
   14, dw 15, bn_pool fwd 15, bwd 15, every other kernel 0), a finite loss,
   that every parameter, sx, sq and RGB BatchNorm statistic moved, and that
   a second run from the same seeds repeats the first step bit for bit
   (loss, every gradient, every parameter); every train kernel call of the
   step against its plain version (bars as in 6); time the step as in 7,
   and conv fwd, dx, bn_pool fwd and bwd per proj step and call by call as
   in 7;
12. ``I2PNET_POOL_BWD=pallas``: one proj step (no-tap bn_pool fwd 15,
   recompute bwd 15, the idx pair 0), every call of those two kernels equal
   to its plain version and every recompute call to (d)'s dz on (c)'s
   taps, and ``fused_stage_train`` at the shapes of the
   proj encoder's first two stages bit-identical (out, dx where the input
   has one, dw, db, dgamma, dbeta) under pallas and idx for one cotangent;
13. a train-mode proj forward under ``torch.no_grad()``: the no-tap
   forward in every block (15), the idx forward 0;
14. ``I2PNET_FUSED_TRAIN=0 I2PNET_POOL_PALLAS=1``: one proj step on the
   native chain (pool route 10 at stride 1, 5 at stride 2, the train
   kernels 0), every route call equal to its plain version; then the
   pallas pair and the route kernels timed as in 7 (the route's library
   call is ``max_pool2d_with_indices_backward`` on the same routing);
15. past the kernels' former limits, one run with the counts at 0 (FPS
   2, select 1, nothing else): FPS at 20000 and 40000 points (the any-N
   kernel) and the window select with 17 x 17 slots (the shared-memory
   path), each equal to its plain version and timed; the bf16 encoder
   stage with 12 output channels at eval and in training, which the gates
   send to the native chain.
16. the evaluation CLI: a synthetic KITTI large-range test tree on disk
   (sequences 7 and 8, 13 frames each: (7, 120000) f32 scans, which the
   loader pads to 150,000 points, and (376, 1241, 3) uint8 images), two
   cascade stages of the shipped proj config with different seeded weights
   saved through the port's ``CheckpointManager``, and
   ``evaluate_torch.main`` in bf16 at B=8 (batches of 8, 8, 8 and 2); checks
   the summary (finite, count 26), prediction.txt (26 sections, parsed by
   the port's analysis), the metrics npz (``recall_analysis``), the native
   IO library, the launches (select 5 and encoder block 15 a stage and
   batch, nothing else), every select and encoder-block call against its
   plain version (the bars of phase 3), and the first batch's cascade
   against a hand-composed pair of forwards, bit for bit; prints the
   evaluator's mean_time_s / mean_fps and the host's time to load a sample;
17. the free-point ``Evaluator`` on an in-memory dataset (B=8, 384x1280,
   8192 points, 3 batches, seeded decalibrations), two stages of the
   shipped config in bf16 through the checkpoints: the same checks, with
   FPS 4, encoder block 15 and cv1 1 a stage and batch;
18. training through the CLI: ``train_torch.main`` on a large-range tree of
   its own (training sequences 0-1 with 16 frames, validation 9 with 8:
   4 steps and one validation batch an epoch), the shipped proj config in
   bf16 at B=8, 2 epochs with 2 loader workers; checks the trainer's
   files (the JAX trainer's names), finite losses, that every parameter
   and statistic moved, the checkpoints and bests, the launches of the run
   and of the first step (conv fwd 15, dx 14, dw 15, bn_pool fwd 15, bwd
   15) and the first validation batch (encoder block 15, select 5), every
   kernel call of those two against its plain version (the other steps
   run with no capture); then ``--resume --max_epoch 3`` (starts at epoch
   2, Adam's state restored), ``evaluate_torch.main --analyze`` on the
   rotation-best snapshot over phase 16's test split; then, timed, two
   epochs of 16 steps (the training frames linked 4 times) from scratch at
   each of ``--num_workers 2``, ``4`` and ``0``, printing the trainer's ms
   a step and pairs/s with the loading, and the loader's ms a batch alone;
19. the free-point ``Trainer`` on in-memory pairs, the shipped config in
   bf16 at B=8 in 2 microbatches a step (``accum_steps=2``), 2 epochs of 2
   steps: the launches (FPS 4 and the train kernels a microbatch; FPS 4,
   encoder block 15, cv1 1 a validation batch), the first step's and first
   validation batch's kernel calls against their plain versions, finite
   metrics; and on the proj model, two steps of
   ``make_accum_train_step(accum_steps=1)`` bit-identical to
   ``make_train_step_proj`` from one copied state;
20. ``tools/synthetic_convergence_torch.py``'s loop on the shipped free
   config in bf16 at B=8, 100 steps: RRE and RTE on its held-out batch
   must fall;
21. the online-calibration (efgh) model: the shipped config with
   ``efgh=True`` in bf16 at B=8, the raw loader's 352x1216 images, 8192
   camera-frame points at a raw drive's ranges (5-120 m) and calib = the
   resized KITTI raw K @ [I|0] (as ``emit_calib`` builds it): the eval
   forward (FPS 4, encoder block 15, cv1 1 at K = 11x38 = 418; FPS and the
   blocks against their plain versions at the bars of phase 3; cv1 within
   1/256 of its output's largest magnitude of its plain version and no
   further than it from the exact f64 chain, and on a 10-30 m cloud within
   phase 3's 5e-3; a repeat identical; eager and graph-replayed times), a
   2-stage ``Evaluator`` cascade threading calib (16 pairs; its files; the
   first batch against a hand-composed pair of forwards, bit for bit) and
   its throughput over 12 batches with no capture on, and the train step (dropout, Adam: the train kernels' launches, every call
   against its plain version at phase 6's bars, every parameter and
   statistic moved; timed);
22. the projection-mask branch at the bench shape (``use_projection_mask``,
   both mask heads, ``ground_truth_projection_mask``, ``mask_delay``; bf16,
   B=8, 384x1280, 8192 points): a train step with ``train_target="all"``
   (timed), the ``Trainer`` for 2 epochs of 2 steps with
   ``train_target="class"`` (``model_acc_best`` written, the mask accuracy
   finite), a step of the ``mask_sigmoid`` heads (without the ground-truth
   mix, which JAX's sigmoid head cannot broadcast), and the eval-time
   gt-mask fallback forward (pm3 one-hot);
23. eval forwards of the shipped config in bf16 at the bench shape with
   each option: the ``concat`` and ``cosine`` correlations, ``max_cost``,
   ``backward_fc`` (cv1 0: JAX fuses none of them) and non-empty pose-head
   MLPs with each ``head_corr_func``, with and without the position
   embedding (cv1 1);
24. the KITTI odometry small-range protocol (``kd_cmr_snr``, ``i2pnet``:
   ``train_torch.py``'s defaults) from a tree on disk (sequence 03 with 24
   frames, 00 with 16; local maps of 120,000 points of a street, 376x1241
   frames, calib.txt; the 10-seed protocol's per-seed pickles):
   ``train_torch.main`` in bf16 at B=8 for 2 epochs of 3 steps (the first
   step's kernel calls against their plain versions, every parameter and
   statistic moved), then ``scripts/cmr_test_torch.sh``'s protocol in
   process (``evaluate_torch.main`` for each of 10 seeds, its pickle read by
   ``load_test_rt``; seed 0's kernel calls against their plain versions, its
   out3 finite with unit quaternions), ``aggregate_seeds`` over the ten
   prediction files, and the evaluator's mean_fps on seed 0's split
   repeated 6 times with no capture on;
25. nuScenes large-range (``nus_corr_nolidar``) on
   ``I2PNetProjConfig.nuscenes()`` in bf16 at B=8: 16 maps of 100k-150k
   points (zero-padded to 150,000) and 900x1600 frames cropped to 160x512
   by the loader; the eager forward and its CUDA-graph replay, each
   repeated bit for bit (select 5 on the 32-row grid, encoder block 15;
   every call against its plain version), the train step (dropout, Adam;
   the train kernels' launches and calls) and a 2-stage ``Evaluator`` over
   the 16 test pairs;
26. nuScenes small-range (``nus_cmr_snr``) on the shipped free config in
   bf16 at B=8 and the loader's 640x1280, 8192 points drawn from maps of
   50k-80k: the eager forward and its graph replay (FPS 4, encoder block
   15, cv1 1 at K = 20x40 = 800; every call against its plain version),
   the train step (every call against its plain version at 640x1280;
   timed, with ``torch.cuda.max_memory_allocated``), and
   ``evaluate_torch.main`` with a ``--test_rt`` CSV in the reference's
   ``id,tx,ty,tz,rx,ry,rz`` layout;
27. the reference-checkpoint bridge and ``--vis_rate``: the seeded models
   of phases 4 and 10 written under the reference RegNet_v2's names in its
   file layout (``{"model_state_dict": {"module." + name: tensor}}``, by
   the inverse of the bridge, ``reference_names``), converted by
   ``tools/reference_ckpt_to_torch.py`` (bit-identical to the seeded
   weights), then ``evaluate_torch.main --vis_rate 1`` in bf16 at B=8 on
   phase 24's KITTI odometry tree (free, 2 batches) and on a large-range
   tree (proj, 3 batches) with a recording writer: the launches, every
   kernel call against its plain version, out3 of the first batch equal to
   the seeded model's, the four tags every batch, the init, gt and pred
   panels equal to ``render_projection`` re-run in numpy; the whole pass's
   pairs/s with and without the overlays;
28. ``tools/render_demo_torch.py`` on the bridged models at B=1 (free on
   the CMR tree with ``--heat``, proj on the large-range tree): a first
   frame with every kernel call against its plain version and timed (FPS
   4, block 15, cv1 1; select 5, block 15), then 8 frames, every PNG
   decoded with zlib equal to its panel, ms a frame split into forward,
   render and PNG write; then ``tools/render_real_demo_torch.py`` on a
   real-rig tree (velodyne ``.bin`` scans, PNG frames that
   ``realloc.read_image`` decodes with cv2 or PIL) with phase 27's free
   prediction file;
29. the offline builders on the card's host from raw files numpy writes:
   a KITTI odometry sequence (velodyne ``.bin``, ``poses.txt``,
   ``calib.txt``) through ``bin_to_npy_with_normals``, ``poses_to_npz``,
   ``process_sequence_accumulation`` and ``build_local_maps``, read by
   ``KittiOdometryCMRDataset``; a nuScenes v1.0 JSON tree through
   ``NuScenesLite`` and ``generate_split``, read by ``NuScenesCMRDataset``;
   one free forward on the card from each, every kernel call against its
   plain version; the builders' seconds;
30. data parallelism: two ranks on the one card (``torch.multiprocessing``
   with spawn, gloo, CUDA tensors; time-sliced, so its times are no
   scaling figure, and NCCL across cards is not exercised), B=4 a rank of
   the global 8: the shipped proj and free steps in bf16 (dropout off;
   launches a rank as the one-process step's, every kernel call against
   its plain version, the loss within 2e-3 of the one-process step's, the
   gradients no further from the f32 step than its, the ranks bit-identical,
   a second run bit-identical) and in f32 (loss 1e-4, running statistics
   1e-5, the gradients' relative L2 gap at ``F32_GRAD_BARS``); every
   reading printed beside its controls (the same step with its sums in
   another order: one process on the rows reversed, in f32 one process at
   B=4 twice and the ranks on their rows reversed) and beside two faults
   planted in the statistics' all-reduce (``planted``), each of which must
   break a bar (the block comment at ``dp_phase``); the ``Trainer`` at W =
   2 (2 steps, 1 validation batch; rank 0's files, the one-process run's
   names); the ``Evaluator``'s fan-out of both 2-stage cascades over 27
   large-range and 19 free pairs (ragged last batches: free out3
   bit-identical, proj within 1e-4 in f32 and no further from the f32
   cascade than one process in bf16; prediction.txt's sections); then
   ``train_torch.py`` and ``evaluate_torch.py --dp`` (on its checkpoint,
   against ``evaluate_torch.py`` in a plain process) under
   ``torch.distributed.run --nproc_per_node 1`` (NCCL); the DP step's ms
   and the fan-out's pairs/s beside one process's; and the accumulating proj
   step (``accum_steps=2``, each rank loading its share of each global
   microbatch, ``host_batch_rows``) in bf16 and f32 against the
   one-process accumulating step, at the same bars beside its controls
   (the rows reversed within each microbatch), the two planted faults and a
   third, 'contiguous' (each rank's contiguous rows cut into microbatches);
31. the serving export: ``tools/export_model_torch.py``'s ``export_model``
   on the shipped bf16 forwards (free at B=8 and B=1, proj at B=8), each
   program saved to a file and served in a fresh ``python3`` that imports
   torch and ``i2pnet_tpu_torch.ops.library`` alone (``serve_exported``):
   q/t bit-identical to the eager forward, launches free FPS 4, encoder
   block 15, cv1 1 and proj block 15, select 5, every call within its bar
   against its plain version; the served forward's ms (3 windows of 20, and
   graph-replayed) beside the eager forward's;
32. the protocol rehearsal: ``tools/protocol_rehearsal_torch.py --families
   proj`` at a reduced size (``REHEARSAL_ARGS``): train_torch.py ->
   checkpoints -> evaluate_torch.py --analyze, its JSON lines, files and
   finite metrics over the 8 test pairs;
33. the code no model path runs, at full width: a ``dist_mode``
   ``ProjectPointNet`` at the shipped ``lidar_lv1`` geometry on phase 10's
   range images (B=8, 64x1800 -> 16x225): the bf16 eval forward on the
   dense route (select 1, every call equal to its plain version), the f32
   dense route against the f32 gathered one, a train-mode forward and
   backward against the CPU's; a ``dist_mode`` ``ProjSetUpconv`` at the
   first upconv's geometry (4x57 from 4x29), card against CPU, its
   gradients too; ResNet-34 (``nn/resnet.py``) at B=8, 384x1280, bf16 and
   f32: the card's f32 eval output against the CPU's (TF32 off, and on as
   the control), the eager and graph-replayed forwards' ms, a train step's
   ms and the peak memory; the generic window select + ``gather_grid``
   against the grid select at the ``lidar_lv1`` geometry; the im2col
   candidate builder against the default (``window_candidates``), bit for
   bit and timed, at ``lidar_lv1`` and at every call site of the shipped
   proj model's train step and eval forward, and the whole forward and
   step under each;
34. the dense level kernel (``csrc/dense_level.cu``) at each dense level
   of the shipped bf16 proj model, on phase 10's inputs and on the
   benchmark's large-range sweep: every level on the kernel, each call's
   launches counted (2L + 1), its features against the plain chain's
   within 0.01 * max(|ref|, 1), and on the sweep each level's module call
   timed by graph replay beside the plain chain and its bound.

The script assumes no h5py: phases 24-29 stand in for the loaders' map
read (``read_local_map``) and the builders' h5 writes
(``write_local_map``) alone, on files numpy wrote under the loaders'
names. Camera frames are PNGs (``write_png``) under the loaders' names,
decoded by the loaders' own ``read_image`` and held to the arrays written,
where PIL (nuScenes) or cv2 or PIL (the real rig) is installed; without
them .npy frames stand in (``read_npy_frame``). Each kernel's calls
on the new paths (``new_paths`` in the JSON line; the B=1 calls of phase
28 under ``demo_*_first_frame``).

Phases 4 and 10 also time each encoder-block call beside ``F.conv2d`` on
its conv, and phase 4 gives cv1's TFLOP/s.

Prints the kernels' JSON line (times, bounds, launches on the path each
row was timed on, and the launches on every path), then as its last line
``{"ok": true, "device": {...}}``. Run: ``python3 chip_smoke.py``
(``--profile`` adds torch.profiler breakdowns of the free forward, the
train step, the proj forward and the proj train step; ``--phase N`` runs
the build and phase N alone, for N = 30 to 34, and prints neither JSON
line). It never runs on
the CPU: without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

BATCH, IMG_H, IMG_W = 8, 384, 1280
# bench.py's proj inputs: raw points a row (the last PROJ_PAD of them zero),
# the image, and the decalibration of the cloud
PROJ_POINTS, PROJ_PAD, PROJ_H, PROJ_W = 150000, 30000, 160, 512
PROJ_Q, PROJ_T = (0.999, 0.0, 0.04, 0.0), (1.0, 0.0, 2.0)
WINDOWS, ITERS = 3, 20
KERNEL_REPEATS = 5
SEED = 0
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): the bound
# of a kernel is the larger of its bytes over the memory rate and its
# operations over the peak rate of their type
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
NO_LAUNCHES = dict.fromkeys(
    ("fps", "encoder_block", "cv1", "conv_fwd", "conv_dx", "conv_dw", "bn_pool_fwd", "bn_pool_bwd",
     "bn_pool_fwd_notap", "bn_pool_bwd_recompute", "pool_route_s1", "pool_route_s2", "select",
     "dense_level"), 0)
TRAIN_LAUNCHES = dict(NO_LAUNCHES, fps=4, conv_fwd=15, conv_dx=14, conv_dw=15, bn_pool_fwd=15,
                      bn_pool_bwd=15)
# a bf16 proj eval forward: the RGB encoder's blocks, and its five dense
# levels (lidar_lv1-4, layer_idx), each the select kernel once and the dense
# level kernel 2L + 1 = 7 times (three layers)
PROJ_FORWARD = dict(encoder_block=15, select=5, dense_level=35)
PROJ_LAUNCHES = dict(NO_LAUNCHES, **PROJ_FORWARD)
# the proj train step on each pool backend: the default (idx), pallas (no
# taps, recomputed), a forward without gradient, and the native chain
# (I2PNET_FUSED_TRAIN=0) with the routed pool
PROJ_TRAIN_LAUNCHES = dict(NO_LAUNCHES, conv_fwd=15, conv_dx=14, conv_dw=15, bn_pool_fwd=15,
                           bn_pool_bwd=15)
PROJ_PALLAS_LAUNCHES = dict(NO_LAUNCHES, conv_fwd=15, conv_dx=14, conv_dw=15, bn_pool_fwd_notap=15,
                            bn_pool_bwd_recompute=15)
PROJ_NOGRAD_LAUNCHES = dict(NO_LAUNCHES, conv_fwd=15, bn_pool_fwd_notap=15)
PROJ_ROUTED_LAUNCHES = dict(NO_LAUNCHES, pool_route_s1=10, pool_route_s2=5)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def elapsed_ms(fn) -> float:
    """fn()'s time in ms between two CUDA events, synchronised."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def cuda_ms(fn, repeats: int) -> float:
    """Median over `repeats` of fn()'s time in ms, after one warm-up call."""
    fn()
    return statistics.median(elapsed_ms(fn) for _ in range(repeats))


def windows_ms(fn, iters: int = ITERS):
    """Median ms of one fn() over WINDOWS windows of `iters` calls, and the
    windows' spread in percent of it."""
    windows = [elapsed_ms(lambda: [fn() for _ in range(iters)]) / iters for _ in range(WINDOWS)]
    med = statistics.median(windows)
    return med, (max(windows) - min(windows)) / med * 100.0


def graph_of(fn):
    """A CUDA graph of fn's launches, captured after a warm-up on a side
    stream; replaying it measures device time without the host's gaps."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def replay_ms(fn) -> float:
    return cuda_ms(graph_of(fn).replay, KERNEL_REPEATS)


def in_graph_ms(fn, n: int = 10) -> float:
    """fn's time a call with n calls in one graph: the graph's own launch,
    which a single call's replay carries whole, spread over n."""
    return replay_ms(lambda: [fn() for _ in range(n)]) / n


def make_inputs(cfg, device):
    """The inputs bench.py makes, from numpy with seed 0."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    rgb = rng.normal(size=(BATCH, IMG_H, IMG_W, 3)).astype(np.float32)
    lidar = rng.uniform(-10, 10, size=(BATCH, cfg.lidar_in_points, 3)).astype(np.float32)
    lidar[..., 2] += 20.0
    k = np.tile(np.array([[[718.0, 0, IMG_W / 2], [0, 718.0, IMG_H / 2], [0, 0, 1]]], np.float32),
                (BATCH, 1, 1))
    return tuple(torch.from_numpy(a).to(device) for a in (rgb, lidar, k))


def make_proj_inputs(device):
    """The proj inputs bench.py makes, from numpy with seed 0: (rgb,
    decalibrated cloud, raw cloud, intrinsic)."""
    import numpy as np
    import torch

    from i2pnet_tpu_torch.ops import quaternion as Q

    rng = np.random.default_rng(SEED)
    raw = rng.normal(size=(BATCH, PROJ_POINTS, 3)).astype(np.float32) * 15
    raw[:, PROJ_POINTS - PROJ_PAD:] = 0.0
    rgb = rng.normal(size=(BATCH, PROJ_H, PROJ_W, 3)).astype(np.float32)
    k = np.tile(np.array([[[350.0, 0, 256], [0, 350.0, 80], [0, 0, 1]]], np.float32),
                (BATCH, 1, 1))
    rgb, raw, k = (torch.from_numpy(a).to(device) for a in (rgb, raw, k))
    q = torch.tensor([PROJ_Q], device=device).repeat(BATCH, 1)
    t = torch.tensor([PROJ_T], device=device).repeat(BATCH, 1)
    lidar = Q.warp_points(raw, q, t) * (torch.sum(raw**2, -1, keepdim=True) > 0)
    return rgb, lidar, raw, k


class Capture:
    """Records each kernel wrapper's arguments and result during a run."""

    def __init__(self, module, name):
        self.module, self.name, self.fn = module, name, getattr(module, name)
        self.calls = []

    def __enter__(self):
        def wrapped(*args):
            out = self.fn(*args)
            self.calls.append((args, out))
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(byte_count: float, ops: float, peak: float):
    """(ms, what bounds it) of one call: bytes or operations."""
    t_bytes, t_ops = byte_count / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def conv_flops(x, cin, cout) -> float:
    B, H, W = x.shape[:3]
    return 2.0 * B * H * W * 9 * cin * cout


# the bound of one call of each kernel, from its arguments and result
BOUNDS = {
    # FPS: per step a distance (3 sub, 3 mul, 2 add), a min and a compare
    # over every point, in f32; its serial chain of npoint steps is the real
    # limit, which no rate bound sees
    "fps": lambda a, out: bound(nbytes(a[0], out), 10.0 * a[0].shape[0] * a[1] * a[0].shape[1],
                                F32_FLOPS),
    "encoder_block": lambda a, out: bound(nbytes(a[0], a[1], a[2], a[3], out),
                                          conv_flops(a[0], a[1].shape[2], a[1].shape[3]),
                                          BF16_FLOPS),
    "cv1": lambda a, out: bound(nbytes(*a, out), cv1_flops(a), BF16_FLOPS),
    "conv_fwd": lambda a, out: bound(nbytes(a[0], a[1], a[2], out),
                                     conv_flops(a[0], a[1].shape[3], a[1].shape[0]), BF16_FLOPS),
    "conv_dx": lambda a, out: bound(nbytes(a[0], a[1], out),
                                    conv_flops(a[0], a[1].shape[3], a[1].shape[0]), BF16_FLOPS),
    "conv_dw": lambda a, out: bound(nbytes(a[0], a[1], out),
                                    conv_flops(a[0], a[0].shape[3], a[1].shape[3]), BF16_FLOPS),
    # elementwise work (affine, activation, rounding, compares): a few f32
    # operations per element, far below the bytes
    "bn_pool_fwd": lambda a, out: bound(nbytes(a[0], a[1], a[2], *out),
                                        4.0 * a[0].numel() + 9.0 * out[0].numel(), F32_FLOPS),
    "bn_pool_bwd": lambda a, out: bound(nbytes(a[0], a[1], a[2], a[3], a[4], out),
                                        13.0 * out.numel(), F32_FLOPS),
    "bn_pool_fwd_notap": lambda a, out: bound(nbytes(a[0], a[1], a[2], out),
                                              4.0 * a[0].numel() + 9.0 * out.numel(), F32_FLOPS),
    # the activation recomputed once, a 9-tap scan per pooled cell, the
    # gather and slope per input element
    "bn_pool_bwd_recompute": lambda a, out: bound(
        nbytes(a[0], a[1], a[2], a[3], out),
        4.0 * a[0].numel() + 9.0 * a[3].numel() + 13.0 * out.numel(), F32_FLOPS),
    # a compare per covering cell of every input element, an add per cell
    "pool_route_s1": lambda a, out: bound(nbytes(a[0], a[1], out),
                                          9.0 * out.numel() + a[1].numel(), F32_FLOPS),
}
BOUNDS["pool_route_s2"] = BOUNDS["pool_route_s1"]


def select_ops(a, m) -> float:
    """The select's f32 operations on this run's data: per slot its
    distance and validity (13), and for every query with a valid slot one
    pass of 2 per slot that selects (the nearest, or a radix round)."""
    S = a[4][0] * a[4][1]
    found = float(((m[..., :S] > 0).sum(-1) > 0).sum())
    return 13.0 * m.shape[0] * m.shape[1] * S + 2.0 * S * found


BOUNDS["select"] = lambda a, out: bound(nbytes(a[0], out), select_ops(a, out), F32_FLOPS)


def dense_level_ops(a) -> float:
    """A dense level pass's tensor-core work: each selected slot (m > 0)
    through the layers the pass computes (0..layer; all of them for the
    max), 2 x cin x cout a layer."""
    from i2pnet_tpu_torch.ops import dense_level_cuda

    m, weights, layer, kind = a[3], a[4], a[17], a[18]
    depth = len(weights) if kind == dense_level_cuda.MAX else layer + 1
    return float((m > 0).sum()) * sum(2.0 * w.shape[0] * w.shape[1] for w in weights[:depth])


# the grids, m, the weights and the statistics' sums read once, the sums or
# the features written once
BOUNDS["dense_level"] = lambda a, out: bound(nbytes(a[0], a[1], a[2], a[3], *a[4], *a[8], out),
                                             dense_level_ops(a), BF16_FLOPS)


def cv1_flops(a) -> float:
    """The cv1 chain's multiply-adds per (point, pixel), times 2."""
    pn, qn, w1c, w2, w3, v1a, v1b, v2 = a[0], a[3], a[6], a[7], a[9], a[11], a[12], a[14]
    B, N, _ = pn.shape
    K = qn.shape[1]
    per = sum(w.shape[0] * w.shape[1] for w in (w1c, w2, w3, v1a, v1b, v2))
    return 2.0 * B * N * K * per


def total_bound(name, calls):
    parts = [BOUNDS[name](a, out) for a, out in calls]
    kinds = [k for _, k in parts]
    return sum(ms for ms, _ in parts), max(set(kinds), key=kinds.count)


def library_calls(name, calls):
    """One PyTorch call per kernel call computing the same function, where
    one exists: the yardstick of ``library_ms`` (the port never calls
    these). The operands are converted outside the timed replay."""
    import torch
    import torch.nn.functional as F

    if name == "conv_fwd":  # F.conv2d in bf16, channels_last, with bias; lib(k): call k
        ops = [(x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2), b.to(torch.bfloat16))
               for (x, w, b), _ in calls]
        return lambda k=None: [F.conv2d(x, w, b, padding=1)
                               for x, w, b in (ops if k is None else ops[k:k + 1])]
    if name == "conv_dx":  # the input gradient of the forward conv
        ops = [(g.permute(0, 3, 1, 2), wt.flip(1, 2).permute(3, 0, 1, 2)) for (g, wt), _ in calls]
        return lambda k=None: [torch.nn.grad.conv2d_input(
            (g.shape[0], w.shape[1], g.shape[2], g.shape[3]), w, g, padding=1)
            for g, w in (ops if k is None else ops[k:k + 1])]
    if name == "conv_dw":  # the weight gradient; lib(k) runs call k alone
        ops = [(x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)) for (x, g), _ in calls]

        def lib(k=None):
            return [torch.nn.grad.conv2d_weight(x, (g.shape[1], x.shape[1], 3, 3), g, padding=1)
                    for x, g in (ops if k is None else ops[k:k + 1])]
        return lib
    if name.startswith("pool_route"):  # the pool's backward on the same routing
        ops = [route_as_max_pool_indices(*a) for a, _ in calls]
        return lambda: [torch.ops.aten.max_pool2d_with_indices_backward(
            g, x, [3, 3], [s, s], [1, 1], [1, 1], False, idx) for g, x, idx, s in ops]
    return None  # FPS, the fused blocks, cv1, bn_pool: no single PyTorch call


def route_as_max_pool_indices(argtap, ct, stride, W=None):
    """The operands of ``max_pool2d_with_indices_backward`` for a route call:
    the cotangent and a stand-in input as channels-last NCHW views, and the
    flat first-max index h * W + w of every cell, from its tap (W: the
    input's width, stride * Wo where not given)."""
    import torch

    B, Ho, Wo, C = ct.shape
    W = stride * Wo if W is None else W
    tap = argtap.long()
    oh = torch.arange(Ho, device=ct.device)[None, :, None, None]
    ow = torch.arange(Wo, device=ct.device)[None, None, :, None]
    idx = (oh * stride + tap // 3 - 1) * W + ow * stride + tap % 3 - 1
    x = torch.empty(B, stride * Ho, W, C, dtype=ct.dtype, device=ct.device)
    return ct.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), idx.permute(0, 3, 1, 2), stride


def profile_run(fn, card: str, label: str, iters: int = 10) -> None:
    """Device time by kernel over `iters` calls of fn (torch.profiler), and
    the device's busy share of the wall time; the full table goes to
    chiprun_out/profile_<label>.txt, and the operators grouped by their
    input shapes, which name the layer, to profile_<label>_shapes.txt."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0
    # device kernels only: annotation ranges such as Adam's step also show
    # on the device's timeline and would count twice
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("Optimizer.")]
    busy_ms = sum(e.device_time_total for e in kernels) / 1000.0  # one stream: no overlap
    print(f"profile {label}: {iters} calls, wall {wall_ms / iters:.3f} ms/call (profiler on), "
          f"device busy {busy_ms / iters:.3f} ms/call ({100.0 * busy_ms / wall_ms:.1f}%) "
          f"on {card}")
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1000.0 / iters
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]:
        print(f"profile {label}: {ms:8.3f} ms/call  {name[:100]}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(f"chiprun_out/profile_{label}.txt", "w") as f:
        f.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=80))
    with open(f"chiprun_out/profile_{label}_shapes.txt", "w") as f:
        f.write(prof.key_averages(group_by_input_shape=True).table(
            sort_by="self_cuda_time_total", row_limit=80, max_name_column_width=40,
            max_shapes_column_width=120))


def kernel_row(k, launches, err, calls, card):
    """Time one path's calls of a kernel by graph replay: kernel, plain
    version, library call; and its bound from this run's inputs."""
    fn, plain = getattr(k["module"], k["fn"]), getattr(k["module"], k["plain"])
    if not calls:
        raise RuntimeError(f"chip_smoke: no call of {k['name']} to time")
    k_ms = replay_ms(lambda: [fn(*a) for a, _ in calls])
    p_ms = replay_ms(lambda: [plain(*a) for a, _ in calls])
    lib = library_calls(k["name"], calls)
    l_ms = replay_ms(lib) if lib is not None else None
    b_ms, b_by = total_bound(k["name"], calls)
    lib_txt = f"{l_ms:.3f} ms" if l_ms is not None else "none"
    print(f"{k['name']}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, library {lib_txt}, "
          f"bound {b_ms:.4f} ms ({b_by}) for {len(calls)} calls (graph replay) on {card}")
    return {
        "name": k["name"], "route": "cuda", "source": f"i2pnet_tpu_torch/csrc/{k['src']}",
        "replaces": k["replaces"], "launches": launches, "max_abs_err": err, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
    }


def fps_levels(calls, card) -> None:
    """Each FPS call of one forward (one level of the free path) by graph
    replay, at the launcher's thread count (auto) and at 128, 256, 512 and
    1024 threads a row, in ms and us per step (npoint dependent steps)."""
    from i2pnet_tpu_torch.ops import fps_cuda

    for (xyz, npoint), _ in calls:
        parts = []
        for threads in (0, 128, 256, 512, 1024):
            if threads and xyz.shape[1] > 32 * threads:
                continue
            ms = replay_ms(lambda: fps_cuda.fps_cuda(xyz, npoint, threads))
            parts.append(f"{threads or 'auto'} threads {ms:.4f} ms = {ms * 1e3 / npoint:.3f} us/step")
        print(f"fps level {tuple(xyz.shape)} -> {npoint}: {', '.join(parts)} on {card}")


def dw_shapes(calls, card) -> None:
    """Each conv_dw call of one train step by graph replay, beside
    ``conv2d_weight`` on the same operands and the call's bound."""
    from i2pnet_tpu_torch.ops import conv_train_cuda

    lib = library_calls("conv_dw", calls)
    for k, ((x, g), out) in enumerate(calls):
        ms = replay_ms(lambda: conv_train_cuda.conv_dw_cuda(x, g))
        l_ms = replay_ms(lambda: lib(k))
        b_ms, _ = BOUNDS["conv_dw"]((x, g), out)
        print(f"conv_dw call {k} {tuple(x.shape)} -> {g.shape[-1]}: kernel {ms:.4f} ms, "
              f"conv2d_weight {l_ms:.4f} ms, bound {b_ms:.4f} ms on {card}")


def train_call_shapes(name, calls, card, label: str):
    """Each call of kernel (a) (conv_fwd, conv_dx), (c) (bn_pool_fwd) or (d)
    (bn_pool_bwd) of one train step by graph replay, beside its library call
    -- ``F.conv2d`` or ``conv2d_input`` on the same operands -- or a
    yardstick that is not the same function: for bn_pool_fwd
    ``F.max_pool2d(..., return_indices=True)`` on the activated tensor (the
    pool's share), for bn_pool_bwd ``max_pool2d_with_indices_backward`` on the
    same routing (the routing's share); and the call's bound. Returns the
    rows, kept in the kernels' JSON line."""
    import torch
    import torch.nn.functional as F

    from i2pnet_tpu_torch.ops import conv_train_cuda as ct

    fn = getattr(ct, f"{name}_cuda")
    if name == "bn_pool_bwd":  # a = (y, sc, sh, taps, g, stride)
        ops = []
        for a, _ in calls:
            g, _, idx, st = route_as_max_pool_indices(a[3], a[4], a[5], W=a[0].shape[2])
            ops.append((g, torch.empty_like(a[0]).permute(0, 3, 1, 2), idx, st))

        def lib(k):
            g, x, idx, st = ops[k]
            return torch.ops.aten.max_pool2d_with_indices_backward(
                g, x, [3, 3], [st, st], [1, 1], [1, 1], False, idx)
    elif name == "bn_pool_fwd":  # a = (y, sc, sh, stride): the activation outside the replay
        acts = []
        for (y, sc, sh, st), _ in calls:
            z = y.float() * sc + sh
            a = torch.where(z >= 0, z, 0.1 * z).to(torch.bfloat16)
            acts.append((a.permute(0, 3, 1, 2), st))

        def lib(k):
            a, st = acts[k]
            return F.max_pool2d(a, 3, st, 1, return_indices=True)
    else:
        lib = library_calls(name, calls)
    yardstick = name.startswith("bn_pool")
    rows, total = [], [0.0, 0.0, 0.0, 0.0]
    for k, (a, out) in enumerate(calls):
        ms = replay_ms(lambda: fn(*a))
        x10 = in_graph_ms(lambda: fn(*a))
        l_ms = replay_ms(lambda: lib(k))
        b_ms, _ = BOUNDS[name](a, out)
        shape = list(a[0].shape) + ([a[-1]] if yardstick else [a[1].shape[0]])
        # the bn_pool yardsticks are not the same function: their own key
        lib_key = {"bn_pool_fwd": "pool_yardstick_ms",
                   "bn_pool_bwd": "routing_yardstick_ms"}.get(name, "library_ms")
        rows.append({"shape": shape, "ms": ms, "ms_x10": x10, lib_key: l_ms, "bound_ms": b_ms})
        for i, v in enumerate((ms, x10, l_ms, b_ms)):
            total[i] += v
        lib_name = {"conv_fwd": "F.conv2d", "conv_dx": "conv2d_input",
                    "bn_pool_fwd": "max_pool2d with indices (pool yardstick)"}.get(
            name, "max_pool2d_with_indices_backward (routing yardstick)")
        print(f"{name} {label} call {k} {tuple(shape)}: kernel {ms:.4f} ms ({x10:.4f} ten in a "
              f"graph), {lib_name} {l_ms:.4f} ms, bound {b_ms:.4f} ms on {card}")
    print(f"{name} {label}: {len(calls)} calls one by one {total[0]:.4f} ms ({total[1]:.4f} ten "
          f"in a graph), library {total[2]:.4f} ms, bound {total[3]:.4f} ms on {card}")
    return rows


def select_call_shapes(calls, card):
    """Each select call of one proj forward by graph replay, beside the
    plain version and the call's bound. Returns the rows, kept in the
    kernels' JSON line."""
    from i2pnet_tpu_torch.ops import select_cuda

    rows = []
    for k, (a, out) in enumerate(calls):
        ms = replay_ms(lambda: select_cuda.selection_multiplicity_cuda(*a))
        x10 = in_graph_ms(lambda: select_cuda.selection_multiplicity_cuda(*a))
        p_ms = replay_ms(lambda: select_cuda.selection_multiplicity_plain(*a))
        b_ms, _ = BOUNDS["select"](a, out)
        shape = [*a[0].shape[:3], a[1], a[2], *a[4], a[5]]
        rows.append({"shape": shape, "ms": ms, "ms_x10": x10, "plain_ms": p_ms, "bound_ms": b_ms})
        print(f"select proj forward call {k} (B, h2, w2, out_h, out_w, kh, kw, K) {tuple(shape)}: "
              f"kernel {ms:.4f} ms ({x10:.4f} ten in a graph), plain {p_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms on {card}")
    return rows


def block_shapes(calls, card, label: str) -> None:
    """Each encoder-block call of one forward by graph replay, beside
    ``F.conv2d`` (bf16, channels_last) on its conv alone -- a yardstick of
    the conv's share, not the same function -- and the call's bound."""
    import torch
    import torch.nn.functional as F

    from i2pnet_tpu_torch.ops import conv_cuda

    total = [0.0, 0.0]
    for k, ((x, w, sc, sh, s), out) in enumerate(calls):
        ms = replay_ms(lambda: conv_cuda.conv_block_cuda(x, w, sc, sh, s))
        xn = x.permute(0, 3, 1, 2)
        wn = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        c_ms = replay_ms(lambda: F.conv2d(xn, wn, padding=1))
        b_ms, _ = BOUNDS["encoder_block"]((x, w, sc, sh, s), out)
        total[0] += ms
        total[1] += c_ms
        print(f"encoder_block {label} call {k} {tuple(x.shape)} -> {w.shape[3]} s{s}: kernel "
              f"{ms:.4f} ms, F.conv2d {c_ms:.4f} ms, bound {b_ms:.4f} ms on {card}")
    print(f"encoder_block {label}: {len(calls)} calls one by one {total[0]:.4f} ms, F.conv2d "
          f"{total[1]:.4f} ms on {card}")


def check_outputs(out, out2, label: str) -> None:
    """out3/out4 finite (B, 7) with unit quaternions, and a second forward's
    out3 identical."""
    import torch

    for key in ("out3", "out4"):
        o = out[key]
        check(tuple(o.shape) == (BATCH, 7) and bool(torch.isfinite(o).all()),
              f"{label} {key} not finite (B,7)")
        qn = torch.linalg.norm(o[:, :4], dim=-1)
        check(bool(((qn - 1).abs() <= 1e-3).all()), f"{label} {key} quaternion norms {qn.tolist()}")
    check(torch.equal(out["out3"], out2["out3"]), f"{label}: a second forward gave another out3")
    print(f"{label} out3[0] = {[round(v, 6) for v in out['out3'][0].tolist()]}")


def eval_kernel_error(name, plain, calls) -> float:
    """Hold one eval kernel's calls against its plain version; the worst
    max abs error. FPS and select exactly; the encoder block and a dense
    level pass within 0.01 * max(|ref|, 1) (one bf16 ulp of f32 sums in
    another order); cv1 within 5e-3."""
    import torch

    worst = 0.0
    for args, got in calls:
        ref = plain(*args)
        err = float((got.float() - ref.float()).abs().max())
        worst = max(worst, err)
        if name in ("fps", "select"):
            check(torch.equal(got, ref), f"{name} differs from its plain version at "
                                         f"{tuple(args[0].shape)}, {args[1:]}")
        elif name in ("encoder_block", "dense_level"):
            bar = 0.01 * max(float(ref.float().abs().max()), 1.0)
            check(err <= bar, f"{name} {tuple(args[0].shape)}: {err} > {bar}")
        else:
            check(err <= 5e-3, f"cv1: max abs err {err} > 5e-3")
    print(f"{name}: {len(calls)} calls match the plain version, max abs err {worst:.3e}")
    return worst


def train_kernel_error(name, fn, plain, calls) -> float:
    """Hold one train kernel's calls against its plain version; the worst
    max abs error. conv fwd/dx within 0.01 * max(|ref|, 1) (one bf16 ulp
    of f32 sums in another order); dw within 2e-3 * max|ref| and repeatable
    bit for bit; bn_pool out, taps and dz, and the route's dx, exactly."""
    import torch

    worst = 0.0
    for args, got in calls:
        ref = plain(*args)
        shape = tuple(args[0].shape)
        if name == "bn_pool_fwd":
            check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
                  f"bn_pool_fwd {shape}: out or taps differ")
            got, ref = got[0], ref[0]
        err = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        if name == "conv_dw":
            check(err <= 2e-3 * scale, f"conv_dw {shape}: {err} > 2e-3 * {scale}")
            check(torch.equal(fn(*args), got), f"conv_dw {shape} not repeatable")
        elif name in EXACT:
            check(torch.equal(got, ref), f"{name} {shape}: max abs err {err}")
        elif name != "bn_pool_fwd":
            check(err <= 0.01 * max(scale, 1.0), f"{name} {shape}: {err} > 0.01 * {scale}")
        worst = max(worst, err)
    return worst


# the kernels whose every call of a step is timed alone (and kept in the
# JSON line), in the free and the proj step
PER_CALL = ("conv_fwd", "conv_dx", "bn_pool_fwd", "bn_pool_bwd")

EXACT = ("bn_pool_bwd", "bn_pool_fwd_notap", "bn_pool_bwd_recompute", "pool_route_s1",
         "pool_route_s2")


LIMITS_LAUNCHES = dict(NO_LAUNCHES, fps=2, select=1)


def past_limits(launches_of, fps_cuda, select_cuda, dev, card) -> None:
    """FPS at 20000 and 40000 points and the window select with 17 x 17
    slots, each equal to its plain version; the bf16 encoder stage with 12
    output channels, which no kernel takes, on the native chain at eval and
    in training. One run with the counts at 0: FPS 2, select 1, nothing
    else."""
    import numpy as np
    import torch

    from i2pnet_tpu_torch.nn.layers import RGBEncoderStage

    rng = np.random.default_rng(SEED)
    clouds = [torch.from_numpy((np.round(rng.normal(size=(2, n, 3)) * 4) / 4).astype(np.float32))
              .to(dev) for n in (20000, 40000)]
    grid = np.round(rng.normal(size=(2, 64, 1800, 3)) * 8) / 4
    grid[rng.random((2, 64, 1800)) < 0.3] = 0.0
    grid = torch.from_numpy(grid.astype(np.float32)).to(dev)
    sel_args = (grid, 16, 225, (4, 8), (17, 17), 32, 3.0)
    stage = RGBEncoderStage(3, (12, 16), (2, 1), torch.bfloat16).to(dev)
    img = torch.randn(BATCH, IMG_H, IMG_W, 3, device=dev,
                      generator=torch.Generator(dev).manual_seed(SEED))
    got = {}

    def run():
        got["fps"] = [fps_cuda.fps_cuda(xyz, 1024) for xyz in clouds]
        got["select"] = select_cuda.selection_multiplicity_cuda(*sel_args)
        with torch.no_grad():
            got["eval"] = stage.eval()(img)
        out = stage.train()(img)
        out.float().sum().backward()
        got["train"] = out

    launches_of("past_limits", LIMITS_LAUNCHES, run)
    for xyz, idx in zip(clouds, got["fps"]):
        check(torch.equal(idx, fps_cuda.fps_plain(xyz, 1024)),
              f"fps at {tuple(xyz.shape)} differs from its plain version")
        ms = replay_ms(lambda: fps_cuda.fps_cuda(xyz, 1024))
        print(f"fps at {tuple(xyz.shape)} -> 1024: equal to the plain version; {ms:.3f} ms, "
              f"{ms * 1e3 / 1024:.3f} us/step on {card}")
    m = got["select"]
    check(torch.equal(m, select_cuda.selection_multiplicity_plain(*sel_args)),
          "select with 17 x 17 slots differs from its plain version")
    check(bool((m.sum(-1) == 32).all()) and int((m[..., :-1] > 0).sum(-1).max()) > 1,
          "select with 17 x 17 slots: rows do not sum to K, or no query found neighbours")
    ms = replay_ms(lambda: select_cuda.selection_multiplicity_cuda(*sel_args))
    print(f"select with 17 x 17 slots (290 with the sentinel) at {tuple(grid.shape)}: equal to "
          f"the plain version; {ms:.3f} ms on {card}")
    for key in ("eval", "train"):
        check(got[key].shape == (BATCH, IMG_H // 2, IMG_W // 2, 16)
              and bool(torch.isfinite(got[key].float()).all()), f"cout-12 stage {key} output")
    check(all(p.grad is not None and bool(torch.isfinite(p.grad).all())
              for p in stage.parameters()), "cout-12 stage gradients")
    print("encoder stage with 12 output channels: the native chain at eval and in training, "
          "no kernel launched, finite outputs and gradients")


# phases 16-17: the evaluator, a 2-stage cascade restored through the
# port's checkpoints. The KITTI odometry calibration of sequences 00-02
# stands in for the synthetic tree's calib.txt.
EVAL_STAGES, EVAL_FRAMES, EVAL_SCAN_POINTS = 2, 13, 120000
CLI_BATCHES, FREE_EVAL_BATCHES = 4, 3
CLI_LAUNCHES = dict(NO_LAUNCHES, **{k: v * EVAL_STAGES * CLI_BATCHES
                                    for k, v in PROJ_FORWARD.items()})
FREE_EVALUATOR_LAUNCHES = dict(NO_LAUNCHES, fps=4 * EVAL_STAGES * FREE_EVAL_BATCHES,
                               encoder_block=15 * EVAL_STAGES * FREE_EVAL_BATCHES,
                               cv1=EVAL_STAGES * FREE_EVAL_BATCHES)
# the evaluator's own throughput comes from a second pass with no capture
# on, over each phase's data repeated, so that a dozen full batches count
CLI_REPEATS, FREE_EVAL_REPEATS = 4, 5
TIMED_CLI_BATCHES = -(-2 * EVAL_FRAMES * CLI_REPEATS // BATCH)
TIMED_CLI_LAUNCHES = dict(NO_LAUNCHES, **{k: v * EVAL_STAGES * TIMED_CLI_BATCHES
                                          for k, v in PROJ_FORWARD.items()})
TIMED_FREE_LAUNCHES = {k: v * FREE_EVAL_REPEATS for k, v in FREE_EVALUATOR_LAUNCHES.items()}
KITTI_CALIB = (
    "P2: 7.188560e+02 0.000000e+00 6.071928e+02 4.538225e+01 0.000000e+00 7.188560e+02 "
    "1.852157e+02 -1.130887e-01 0.000000e+00 0.000000e+00 1.000000e+00 3.779761e-03\n"
    "Tr: 4.276802e-04 -9.999672e-01 -8.084491e-03 -1.198459e-02 -7.210626e-03 8.081198e-03 "
    "-9.999413e-01 -5.403984e-02 9.999738e-01 4.859485e-04 -7.206933e-03 -2.921968e-01\n"
)


def write_large_range_tree(root: str, frames=None, seed: int = SEED) -> None:
    """The KITTI large-range loader's layout on disk, ``frames`` {sequence:
    frame count} (the test split, sequences 7 and 8 with EVAL_FRAMES each,
    unless given); a scan is (7, EVAL_SCAN_POINTS) f32 (xyz of a spinning
    LiDAR's returns 2-60 m out, intensity, unit normals), an image
    (376, 1241, 3) uint8."""
    import numpy as np

    rng = np.random.default_rng(seed)
    frames = frames or {7: EVAL_FRAMES, 8: EVAL_FRAMES}
    for seq, count in frames.items():
        seq_dir = os.path.join(root, "kitti_processed_DeepI2P", "data_odometry_velodyne",
                               "sequences", "%02d" % seq)
        for sub in ("voxel0.1-SNr0.6", "image_2_npy"):
            os.makedirs(os.path.join(seq_dir, sub))
        with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
            f.write(KITTI_CALIB)
        for fi in range(count):
            n = EVAL_SCAN_POINTS
            r = rng.uniform(2.0, 60.0, n)
            az = rng.uniform(-np.pi, np.pi, n)
            el = rng.uniform(np.radians(-25.0), np.radians(3.0), n)
            normals = rng.normal(size=(3, n))
            normals /= np.linalg.norm(normals, axis=0)
            scan = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                             r * np.sin(el), rng.uniform(0, 1, n), *normals]).astype(np.float32)
            np.save(os.path.join(seq_dir, "voxel0.1-SNr0.6", "%06d.npy" % fi), scan)
            img = rng.integers(0, 256, size=(376, 1241, 3), dtype=np.uint8)
            np.save(os.path.join(seq_dir, "image_2_npy", "%06d.npy" % fi), img)


class FreeEvalDataset:
    """In-memory samples with the KITTI CMR loader's keys at the shipped
    free-point shapes: a cloud decalibrated by a pose drawn from a seeded
    numpy generator (+-1 m, +-0.2 rad), its inverse the ground truth. With
    ``efgh`` the online-calibration loader's: 352x1216 images, clouds at a
    raw drive's ranges (``drive_cloud``), the resized KITTI raw camera and
    its 'calib' ([K | 0], as ``emit_calib`` builds it)."""

    def __init__(self, count: int, points: int, seed: int = SEED, efgh: bool = False):
        import numpy as np

        from i2pnet_tpu_torch.data import transforms as T

        rng = np.random.default_rng(seed)
        h, w = (EFGH_H, EFGH_W) if efgh else (IMG_H, IMG_W)
        k = efgh_intrinsic() if efgh else np.array(
            [[718.0, 0, IMG_W / 2], [0, 718.0, IMG_H / 2], [0, 0, 1]], np.float32)
        self.samples = []
        for i in range(count):
            raw = drive_cloud(rng, points) if efgh else (
                rng.uniform(-10, 10, size=(points, 3)).astype(np.float32) + [0, 0, 20])
            Pr = T.generate_random_transform(rng, 1.0, 1.0, 1.0, 0.2, 0.2, 0.2, clip_tz=False)
            q, t = T.decalib_ground_truth(np.linalg.inv(Pr)[:3])
            lidar = (raw @ Pr[:3, :3].T + Pr[:3, 3]).astype(np.float32)
            self.samples.append(dict(
                rgb=rng.normal(size=(h, w, 3)).astype(np.float32), lidar=lidar,
                lidar_feats=lidar, raw_point_xyz=raw.astype(np.float32), init_intrinsic=k,
                init_extrinsic=Pr[:3].astype(np.float32), decalib_real_gt=q,
                decalib_dual_gt=t, path_info="00 %06d %06d" % (i, i)))
            if efgh:
                self.samples[-1]["calib"] = np.hstack([k, np.zeros((3, 1), np.float32)])

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


class Repeated:
    """`times` copies of a dataset, one after another."""

    def __init__(self, ds, times: int):
        self.ds, self.times = ds, times

    def __len__(self):
        return self.times * len(self.ds)

    def __getitem__(self, i):
        return self.ds[i % len(self.ds)]


def evaluator_throughput(launches_of, label, want, models, cfg, proj: bool, ds, log_dir):
    """Validate once more with no Capture or CascadeRecorder on, so every
    kernel's output is freed as a user's run frees it; prints the window's
    mean_fps (full batches less the first) and the whole pass's pairs/s
    with the loading on the loader's one thread."""
    import math

    from i2pnet_tpu_torch.data import BatchLoader
    from i2pnet_tpu_torch.eval import Evaluator

    evaluator = Evaluator(models, cfg, proj=proj, log_dir=log_dir)
    t0 = time.perf_counter()
    summary = launches_of(label, want, lambda: evaluator.validate(
        BatchLoader(ds, BATCH, shuffle=False, drop_last=False), save_metrics=False))
    wall = time.perf_counter() - t0
    check(math.isfinite(summary["mean_fps"]) and summary["count"] == len(ds)
          and not summary["timing_includes_compile"], f"{label}: summary {summary}")
    print(f"{label}: mean_time_s {summary['mean_time_s']:.6f}, mean_fps "
          f"{summary['mean_fps']:.2f} pairs/s over {len(ds) // BATCH - 1} timed batches (no "
          f"capture on); the whole pass {len(ds) / wall:.2f} pairs/s with the loading, "
          f"{len(ds)} pairs in {wall:.1f} s")


def collate_first(ds):
    """The first batch of `ds`, as the loader collates it."""
    from i2pnet_tpu_torch.data import collate

    return collate([ds[i] for i in range(BATCH)])


def save_stages(models, root: str):
    """Each stage's weights as its log dir's best snapshot, through the
    port's CheckpointManager; returns the log dirs."""
    from i2pnet_tpu_torch.train.checkpoint import CheckpointManager

    dirs = []
    for i, m in enumerate(models):
        d = os.path.join(root, f"stage_{i}")
        CheckpointManager(d).save_best(
            "model_rotation_best", {"model": m.state_dict()})
        dirs.append(d)
    return dirs


class CascadeRecorder:
    """Keeps every out3 the Evaluator's cascade returns while active."""

    def __enter__(self):
        from i2pnet_tpu_torch.eval.evaluator import Evaluator

        self.cls, self.real, self.outs = Evaluator, Evaluator.cascade, []
        recorder = self

        def cascade(self, mb, bi=0):
            out = recorder.real(self, mb, bi)
            recorder.outs.append(out.clone())
            return out

        Evaluator.cascade = cascade
        return self

    def __exit__(self, *exc):
        self.cls.cascade = self.real


def check_cascade(models, batch, proj: bool, recorded, label: str) -> None:
    """The first batch's cascade equals a hand-composed pair of forwards:
    stage 2 sees the cloud warped by stage 1's pose (and the same calib,
    if any), the poses compose."""
    import torch

    from i2pnet_tpu_torch.ops import quaternion as Q

    rgb, lidar, intr = batch["rgb"], batch["lidar"], batch["init_intrinsic"]
    raw, feats = batch["raw_point_xyz"], batch.get("lidar_feats")

    def forward(m, cloud):
        if proj:
            return m(rgb, cloud, raw, intr, lidar_feature=feats)["out3"]
        return m(rgb, cloud, intr, lidar_feature=feats, raw_xyz=raw,
                 calib=batch.get("calib"))["out3"]

    with torch.no_grad():
        o1 = forward(models[0], lidar)
        o2 = forward(models[1], Q.warp_points(lidar, o1[:, :4], o1[:, 4:]))
        q, t = Q.compose_pose(o2[:, :4], o2[:, 4:], o1[:, :4], o1[:, 4:])
    check(torch.equal(torch.cat([q, t], 1), recorded),
          f"{label}: the first batch's cascade differs from the hand-composed pair of forwards")
    print(f"{label}: the first batch's cascade equals the hand-composed pair of forwards, "
          f"bit for bit")


def check_eval_outputs(summary, log_dir: str, count: int, label: str, tag: str = "") -> None:
    """A finite summary of `count` pairs; prediction<tag>.txt with one
    section a pair, parsed by the port's analysis; the newest metrics npz
    read back (the only one, unless runs share the log dir)."""
    import glob
    import math

    from i2pnet_tpu_torch.eval import SECTION, parse_prediction_file, recall_analysis

    finite = [k for k, v in summary.items() if k != "timing_includes_compile"
              and not math.isfinite(float(v))]
    check(not finite and summary["count"] == count and not summary["timing_includes_compile"],
          f"{label}: summary {summary}")
    path = os.path.join(log_dir, f"prediction{tag}.txt")
    with open(path) as f:
        sections = sum(line.startswith(SECTION) for line in f)
    parsed = parse_prediction_file(path)
    check(sections == count and parsed["pred"].shape == (count, 3, 4),
          f"{label}: prediction{tag}.txt has {sections} sections")
    npz = glob.glob(os.path.join(log_dir, "metrics_*.npz"))
    check((len(npz) == 1 or tag) and recall_analysis(max(npz, key=os.path.getmtime))["count"]
          == count, f"{label}: metrics npz")
    print(f"{label}: summary finite, count {count}; prediction{tag}.txt {sections} sections, "
          f"parsed; metrics npz read back; rre_mean {summary['rre_mean']:.3f} deg, rte_mean "
          f"{summary['rte_mean']:.3f} m")


# phases 18-20: training through the entry points. Phase 18 trains the proj
# family through train_torch.py on a large-range tree of its own (training
# sequences 0-1, validation 9: 4 steps and 1 validation batch an epoch);
# phase 19 the free family through the Trainer with 2 microbatches a step
# (16 training pairs, 2 steps an epoch); phase 20 the free family on
# tools/synthetic_convergence_torch.py's data.
TRAIN_FRAMES = {0: 16, 1: 16, 9: 8}
CLI_STEPS = (TRAIN_FRAMES[0] + TRAIN_FRAMES[1]) // BATCH
PROJ_VAL_LAUNCHES = PROJ_LAUNCHES
FREE_VAL_LAUNCHES = dict(NO_LAUNCHES, fps=4, encoder_block=15, cv1=1)
# the timed epochs: each training frame 4 times, 16 steps an epoch
TIMED_REPEATS, TIMED_WORKERS = 4, (2, 4, 0)
TIMED_STEPS = CLI_STEPS * TIMED_REPEATS
FREE_TRAIN_PAIRS, ACCUM = 2 * BATCH, 2
CONVERGE_STEPS = 100


def run_launches(step, val, steps: int, vals: int):
    """The launches of `steps` train steps and `vals` validation batches."""
    return {k: steps * step[k] + vals * val[k] for k in NO_LAUNCHES}


class FirstCalls:
    """Wraps the step functions a Trainer builds (train/trainer.py's names):
    the first train step and the first eval step each run with their
    kernels' calls captured and their launches counted apart; every later
    call runs bare."""

    NAMES = ("make_accum_train_step", "make_eval_step", "make_eval_step_proj")

    def __init__(self, kernels, read_counts):
        self.kernels, self.read_counts = kernels, read_counts
        self.captures, self.launches = {}, {}

    def wrap(self, label, step):
        import torch

        def wrapped(*args):
            if label in self.launches:
                return step(*args)
            with Captures(self.kernels[label]) as caps:
                torch.cuda.synchronize()
                before = self.read_counts()
                out = step(*args)
                torch.cuda.synchronize()
                after = self.read_counts()
            self.launches[label] = {k: after[k] - before[k] for k in after}
            self.captures[label] = caps
            return out

        return wrapped

    def __enter__(self):
        from i2pnet_tpu_torch.train import trainer

        self.saved = {name: getattr(trainer, name) for name in self.NAMES}
        for name, make in self.saved.items():
            label = "eval" if "eval" in name else "step"
            setattr(trainer, name, lambda *a, _make=make, _label=label, **k:
                    self.wrap(_label, _make(*a, **k)))
        return self

    def __exit__(self, *exc):
        from i2pnet_tpu_torch.train import trainer

        for name, make in self.saved.items():
            setattr(trainer, name, make)


def check_first_calls(first, want_step, want_eval, label: str) -> None:
    """The first step's and the first validation batch's launches, and
    every kernel call of both against its plain version (FPS and select
    exactly, the encoder block and cv1 at phase 3's bars, the train kernels
    at phase 6's)."""
    import torch

    check(first.launches.get("step") == want_step,
          f"{label}: launches in the first step {first.launches.get('step')}")
    check(first.launches.get("eval") == want_eval,
          f"{label}: launches in the first validation batch {first.launches.get('eval')}")
    evals = compact(want_eval) if want_eval is not None else "none (no validation split)"
    with torch.no_grad():
        for step, caps in first.captures.items():
            for k in first.kernels[step]:
                name, calls = k["name"], caps[k["name"]].calls
                check(len(calls) == first.launches[step][name],
                      f"{label}: {len(calls)} captured {name} calls for "
                      f"{first.launches[step][name]} launches")
                plain = getattr(k["module"], k["plain"])
                if name in ("fps", "encoder_block", "cv1", "select"):
                    eval_kernel_error(name, plain, calls)
                else:
                    err = train_kernel_error(name, getattr(k["module"], k["fn"]), plain, calls)
                    print(f"{name}: {len(calls)} calls match the plain version, max abs err "
                          f"{err:.3e}")
    print(f"{label}: the first step's launches {compact(want_step)}, the first validation "
          f"batch's {evals}; every call held against its plain version")


def compact(counts) -> dict:
    return {k: v for k, v in counts.items() if v}


def scalars(log_dir: str, tag: str):
    """[(step, value)] of one tag in the trainer's metrics.jsonl."""
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [(r["step"], r["value"]) for r in recs if r["tag"] == tag]


def proj_training_cli(ctx, work: str, test_root: str) -> None:
    """Phase 18: train_torch.py trains the shipped proj config in bf16 at B=8
    on a large-range tree (2 epochs, 2 loader workers), resumes for a third,
    and evaluate_torch.py evaluates its rotation-best snapshot on phase 16's
    test split; then the timed epochs (``timed_epochs``)."""
    import math

    import torch

    import evaluate_torch
    import train_torch
    from i2pnet_tpu_torch import cli
    from i2pnet_tpu_torch.train.checkpoint import CheckpointManager

    root, log_dir = os.path.join(work, "train_data"), os.path.join(work, "train_run")
    t0 = time.perf_counter()
    write_large_range_tree(root, TRAIN_FRAMES, seed=SEED + 1)
    print(f"phase 18: wrote the large-range training tree ({sum(TRAIN_FRAMES.values())} frames) "
          f"in {time.perf_counter() - t0:.1f} s")
    argv = ["--dataset", "kd_corr_nolidar", "--network", "i2pnet_proj", "--compute_dtype",
            "bfloat16", "--batch_size", str(BATCH), "--root_path", root, "--log_dir", log_dir]
    step_launches = PROJ_TRAIN_LAUNCHES
    initial = {}
    real_build = cli.build

    def build(args):
        model, cfg, proj = real_build(args)
        initial.setdefault("state", {k: v.clone() for k, v in model.state_dict().items()})
        return model, cfg, proj

    cli.build = build
    try:
        with FirstCalls({"step": ctx.train_kernels, "eval": [ctx.block, ctx.select]},
                        ctx.read_counts) as first:
            trainer = ctx.launches_of(
                "proj_train_cli", run_launches(step_launches, PROJ_VAL_LAUNCHES, 2 * CLI_STEPS, 2),
                lambda: train_torch.main(argv + ["--max_epoch", "2", "--num_workers", "2"]))
    finally:
        cli.build = real_build
    check_first_calls(first, step_launches, PROJ_VAL_LAUNCHES, "phase 18")
    del first
    names = set(os.listdir(log_dir))
    want = {"config.json", "metrics.jsonl", "log.txt", "log_rotate.txt", "log_trans.txt",
            "src_snapshot.tar.gz", "torch"}
    check(want <= names, f"phase 18: the trainer's files {sorted(names)}")
    bests = sorted(os.listdir(os.path.join(log_dir, "torch", "best")))
    check(bests == ["model_msee_best.pt", "model_rotation_best.pt", "model_transition_best.pt"],
          f"phase 18: best snapshots {bests}")
    losses = scalars(log_dir, "train/loss")
    check([s for s, _ in losses] == [1, 1 + CLI_STEPS] and all(math.isfinite(v) for _, v in losses),
          f"phase 18: train/loss records {losses}")
    final = trainer.model.state_dict()
    unmoved = [k for k, v in initial["state"].items() if torch.equal(v, final[k])]
    check(not unmoved, f"phase 18: unchanged by training: {unmoved[:5]}")
    mgr = CheckpointManager(log_dir)
    payload, meta = mgr.restore()
    check(mgr.all_steps() == [0, 1] and meta["epoch"] == 1 and meta["n_iter"] == 2 * CLI_STEPS
          and payload["step"] == 2 * CLI_STEPS and meta["best"] == trainer.best
          and all(math.isfinite(trainer.best[k]) for k in ("rotation", "translation", "msee")),
          f"phase 18: checkpoints {mgr.all_steps()}, meta {meta}, bests {trainer.best}")
    print(f"phase 18: train_torch.py, 2 epochs of {CLI_STEPS} steps: files with the JAX trainer's "
          f"names, losses finite ({[round(v, 4) for _, v in losses]}), every parameter and "
          f"statistic moved, checkpoints {mgr.all_steps()}, bests {trainer.best}")
    del trainer, initial, final, payload

    resumed = ctx.launches_of(
        "proj_train_cli_resumed", run_launches(step_launches, PROJ_VAL_LAUNCHES, CLI_STEPS, 1),
        lambda: train_torch.main(argv + ["--max_epoch", "3", "--num_workers", "2", "--resume"]))
    adam_steps = {float(s["step"]) for s in resumed.state.optimizer.state.values()}
    check(resumed.start_epoch == 2 and resumed.state.step == 3 * CLI_STEPS
          and adam_steps == {3.0 * CLI_STEPS} and resumed.ckpt.all_steps() == [0, 1, 2],
          f"phase 18: resumed at epoch {resumed.start_epoch}, step {resumed.state.step}, Adam's "
          f"steps {adam_steps}, checkpoints {resumed.ckpt.all_steps()}")
    print(f"phase 18: --resume started at epoch 2 with the optimizer restored (Adam's step "
          f"{int(3 * CLI_STEPS)} after {CLI_STEPS} more updates)")
    del resumed

    eval_dir = os.path.join(work, "train_eval")
    summary = ctx.launches_of(
        "proj_train_cli_evaluate", run_launches(NO_LAUNCHES, PROJ_VAL_LAUNCHES, 0, CLI_BATCHES),
        lambda: evaluate_torch.main(["--root_path", test_root, "--model_dir", log_dir,
                                     "--compute_dtype", "bfloat16", "--batch_size", str(BATCH),
                                     "--log_dir", eval_dir, "--analyze"]))
    check_eval_outputs(summary, eval_dir, 2 * EVAL_FRAMES, "phase 18 evaluate_torch.py")

    timed_epochs(ctx, root, os.path.join(work, "train_timed"))


def repeated_tree(src: str, dst: str, repeats: int) -> None:
    """``src``'s training sequences with each frame linked ``repeats`` times
    under new numbers, and its validation sequence as it is: a longer epoch
    of the same pairs with no more data written."""
    rel = os.path.join("kitti_processed_DeepI2P", "data_odometry_velodyne", "sequences")
    os.makedirs(os.path.join(dst, rel))
    for seq, count in TRAIN_FRAMES.items():
        a, b = os.path.join(src, rel, "%02d" % seq), os.path.join(dst, rel, "%02d" % seq)
        if seq == 9:
            os.symlink(a, b)
            continue
        os.makedirs(b)
        os.symlink(os.path.join(a, "calib.txt"), os.path.join(b, "calib.txt"))
        for sub in ("voxel0.1-SNr0.6", "image_2_npy"):
            os.makedirs(os.path.join(b, sub))
            for k in range(count * repeats):
                os.symlink(os.path.join(a, sub, "%06d.npy" % (k % count)),
                           os.path.join(b, sub, "%06d.npy" % k))


def timed_epochs(ctx, root: str, runs: str) -> None:
    """train_torch.py from scratch for 2 epochs of TIMED_STEPS steps at each
    loader worker count, no capture: train/epoch_time_s (read after the
    epoch's losses are pulled, so after the card's last step) of the first
    epoch, which forks the pool, and of the second; then the loader alone
    over the same tree."""
    from i2pnet_tpu_torch.data import KittiLargeRangeDataset
    import train_torch

    tree = os.path.join(runs, "data")
    repeated_tree(root, tree, TIMED_REPEATS)
    for workers in TIMED_WORKERS:
        log_dir = os.path.join(runs, f"{workers}_workers")
        argv = ["--dataset", "kd_corr_nolidar", "--network", "i2pnet_proj", "--compute_dtype",
                "bfloat16", "--batch_size", str(BATCH), "--root_path", tree, "--log_dir", log_dir,
                "--max_epoch", "2", "--num_workers", str(workers)]
        t0 = time.perf_counter()
        ctx.launches_of(f"proj_train_cli_timed_{workers}_workers",
                        run_launches(PROJ_TRAIN_LAUNCHES, PROJ_VAL_LAUNCHES, 2 * TIMED_STEPS, 2),
                        lambda: train_torch.main(argv))
        wall = time.perf_counter() - t0
        epoch_s = dict(scalars(log_dir, "train/epoch_time_s"))
        for epoch in (0, 1):
            print(f"phase 18 trainer, --num_workers {workers}, epoch {epoch}: "
                  f"{epoch_s[epoch] * 1e3 / TIMED_STEPS:.1f} ms a step, "
                  f"{TIMED_STEPS * BATCH / epoch_s[epoch]:.2f} pairs/s with the loading "
                  f"(train/epoch_time_s {epoch_s[epoch]:.3f} s for {TIMED_STEPS} steps of "
                  f"B={BATCH}, no capture) on {ctx.card}")
        print(f"phase 18 trainer, --num_workers {workers}: the whole call {wall:.1f} s with "
              f"set-up, 2 validations and 2 checkpoints")
        loader_alone(KittiLargeRangeDataset(tree, mode="train", seed=SEED), workers, ctx)


def loader_alone(ds, workers: int, ctx) -> None:
    """The training split through BatchLoader and prefetch_to_device with
    no step, twice (the second pass reuses a pool): ms a batch."""
    import torch

    from i2pnet_tpu_torch.data import BatchLoader, prefetch_to_device

    loader = BatchLoader(ds, BATCH, shuffle=True, seed=SEED, device_only=True,
                         num_workers=workers)
    passes = []
    try:
        for _ in range(2):
            t0, n = time.perf_counter(), 0
            for _batch in prefetch_to_device(loader, ctx.dev):
                n += 1
            torch.cuda.synchronize()
            passes.append((time.perf_counter() - t0) * 1e3 / n)
        print(f"phase 18 loader alone, --num_workers {workers}: {passes[0]:.1f} ms a batch of "
              f"{BATCH} on the first pass, {passes[1]:.1f} on the second ({n} batches a pass; "
              f"the host of {ctx.card})")
        if workers:
            assembly_times(loader)
    finally:
        loader.close()


def timed_assembly(task):
    """(seconds, bytes pickled) of one batch's assembly, as a pool worker
    assembles it (``data/pipeline.py`` ``_assemble_batch``)."""
    import pickle

    from i2pnet_tpu_torch.data import pipeline

    t0 = time.perf_counter()
    batch = pipeline._assemble_batch(task)
    return time.perf_counter() - t0, len(pickle.dumps(batch, pickle.HIGHEST_PROTOCOL))


def assembly_times(loader) -> None:
    """Where a pool's batch goes: one batch assembled in this process, one
    in a worker alone, two in two workers at once, and a batch's pickle
    round trip here (the pool sends each result through a pipe)."""
    import pickle

    import numpy as np

    from i2pnet_tpu_torch.data import pipeline

    pool = loader._get_pool()
    tasks = [(loader._token, np.arange(k * BATCH, (k + 1) * BATCH), True, (SEED, 9, k))
             for k in range(2)]
    here, nbytes = timed_assembly(tasks[0])
    alone, _ = pool.submit(timed_assembly, tasks[0]).result()
    both = [f.result()[0] for f in [pool.submit(timed_assembly, t) for t in tasks]]
    batch = pipeline._assemble_batch(tasks[0])
    t0 = time.perf_counter()
    pickle.loads(pickle.dumps(batch, pickle.HIGHEST_PROTOCOL))
    trip = time.perf_counter() - t0
    print(f"phase 18 loader: a batch assembles in {here * 1e3:.1f} ms in this process, "
          f"{alone * 1e3:.1f} in a worker alone, {both[0] * 1e3:.1f} and {both[1] * 1e3:.1f} in "
          f"two workers at once; its {nbytes / 1e6:.1f} MB pickle round trip {trip * 1e3:.1f} ms")


def free_training(ctx, cfg, work: str) -> None:
    """Phase 19: the Trainer trains the shipped free config in bf16 at B=8 in
    2 microbatches a step on in-memory pairs, 2 epochs of 2 steps."""
    import math

    import torch

    from i2pnet_tpu_torch.models import I2PNet, init_flax_
    from i2pnet_tpu_torch.train.trainer import Trainer

    model = init_flax_(I2PNet(cfg), torch.Generator().manual_seed(SEED))
    train_ds = FreeEvalDataset(FREE_TRAIN_PAIRS, cfg.lidar_in_points, seed=SEED + 2)
    val_ds = FreeEvalDataset(BATCH, cfg.lidar_in_points, seed=SEED + 3)
    log_dir = os.path.join(work, "free_train")
    steps = FREE_TRAIN_PAIRS // BATCH
    micro = TRAIN_LAUNCHES  # FPS 4 and the train kernels, a microbatch
    step_launches = {k: ACCUM * v for k, v in micro.items()}
    with FirstCalls({"step": [ctx.fps] + ctx.train_kernels,
                     "eval": [ctx.fps, ctx.block, ctx.cv1]}, ctx.read_counts) as first:
        trainer = Trainer(model, cfg, train_ds, val_ds, log_dir=log_dir, batch_size=BATCH,
                          epochs=2, save_rate=1, accum_steps=ACCUM, device="cuda")
        ctx.launches_of("free_train_accum",
                        run_launches(step_launches, FREE_VAL_LAUNCHES, 2 * steps, 2), trainer.train)
    check_first_calls(first, step_launches, FREE_VAL_LAUNCHES, "phase 19")
    del first
    losses = scalars(log_dir, "train/loss")
    val = [v for tag in ("val/rre_mean", "val/rte_mean", "val/msee") for _, v in scalars(log_dir, tag)]
    check(len(losses) == 2 * steps and len(val) == 6
          and all(math.isfinite(v) for v in [v for _, v in losses] + val),
          f"phase 19: losses {losses}, validation {val}")
    print(f"phase 19: Trainer, accum_steps={ACCUM} (microbatches of {BATCH // ACCUM}), 2 epochs of "
          f"{steps} steps: losses {[round(v, 4) for _, v in losses]}, validation finite")
    epoch_s = dict(scalars(log_dir, "train/epoch_time_s"))[1]
    print(f"phase 19 trainer, epoch 1 (no capture): {epoch_s * 1e3 / steps:.1f} ms a step, "
          f"{steps * BATCH / epoch_s:.2f} pairs/s with the loading ({steps} steps of B={BATCH} "
          f"in {ACCUM} microbatches; in-memory pairs on the loader's thread) on {ctx.card}")


def accum_of_one_is_plain(ctx, pcfg, pbatch) -> None:
    """Phase 19 also: from one deep-copied proj model and state, two steps of
    make_accum_train_step(accum_steps=1) and of make_train_step_proj, the
    dropout generator seeded alike, agree bit for bit: metrics, parameters,
    statistics, Adam's moments."""
    import copy

    import torch

    from i2pnet_tpu_torch.models import I2PNetProj, init_random_
    from i2pnet_tpu_torch.train import (create_train_state, make_accum_train_step,
                                        make_train_step_proj)

    base = init_random_(I2PNetProj(pcfg), torch.Generator().manual_seed(SEED))
    runs = []
    for make in (lambda m: make_train_step_proj(m, pcfg),
                 lambda m: make_accum_train_step(m, pcfg, 1, proj=True)):
        m = copy.deepcopy(base)
        st = create_train_state(m, steps_per_epoch=100)
        step, gen = make(m), torch.Generator(ctx.dev).manual_seed(SEED)
        runs.append((m, st, [step(st, pbatch, gen) for _ in range(2)]))
    del base
    (ma, sa, meta), (mb, sb, metb) = runs
    check(all(torch.equal(x[k], y[k]) for x, y in zip(meta, metb) for k in x),
          "phase 19: accum_steps=1 metrics differ from the plain step's")
    sdb = mb.state_dict()
    check(all(torch.equal(v, sdb[k]) for k, v in ma.state_dict().items()),
          "phase 19: accum_steps=1 parameters or statistics differ from the plain step's")
    check(all(torch.equal(sa.optimizer.state[p][key], sb.optimizer.state[q][key])
              for p, q in zip(ma.parameters(), mb.parameters()) for key in ("exp_avg", "exp_avg_sq")),
          "phase 19: accum_steps=1 Adam moments differ from the plain step's")
    print("phase 19: make_accum_train_step(accum_steps=1) on the proj model: two steps bit-identical "
          "to make_train_step_proj (metrics, parameters, statistics, Adam's moments)")


def convergence(ctx) -> None:
    """Phase 20: tools/synthetic_convergence_torch.py's loop on the full free
    config in bf16 at B=8: RRE and RTE on its held-out batch must fall."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "synthetic_convergence_torch.py")
    spec = importlib.util.spec_from_file_location("synthetic_convergence_torch", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    t0 = time.perf_counter()
    rre0, rte0, rre1, rte1 = tool.converge(steps=CONVERGE_STEPS, batch=BATCH, device=ctx.dev)
    check(rre1 < rre0 and rte1 < rte0,
          f"phase 20: no improvement: RRE {rre0:.2f} -> {rre1:.2f} deg, RTE {rte0:.3f} -> {rte1:.3f} m")
    print(f"phase 20: synthetic convergence, free config bf16 B={BATCH}, {CONVERGE_STEPS} steps in "
          f"{time.perf_counter() - t0:.1f} s: RRE {rre0:.2f} -> {rre1:.2f} deg, RTE {rte0:.3f} -> "
          f"{rte1:.3f} m on {ctx.card}")


# phases 21-23: the online-calibration (efgh) model at the raw loader's
# 352x1216, the projection-mask branch at the bench shape, and the grid of
# the cost volume's and the pose heads' options
EFGH_H, EFGH_W = 352, 1216
# the KITTI raw 2011_09_26 camera (the online-calibration loader's), whose
# frames are 375x1242
RAW_K, RAW_HW = ((7.215377e02, 0.0, 6.095593e02), (0.0, 7.215377e02, 1.728540e02),
                 (0.0, 0.0, 1.0)), (375, 1242)
EFGH_STAGE_BATCHES, EFGH_EVAL_REPEATS = 2, 6
EFGH_EVALUATOR_LAUNCHES = {k: v * EVAL_STAGES * EFGH_STAGE_BATCHES
                           for k, v in FREE_VAL_LAUNCHES.items()}
EFGH_TIMED_LAUNCHES = {k: v * EFGH_EVAL_REPEATS for k, v in EFGH_EVALUATOR_LAUNCHES.items()}
STEP_ITERS = 5
MASK_CFG = dict(use_projection_mask=True, layer_mask=(True, True),
                ground_truth_projection_mask=True, mask_delay=True)
HEAD_MLPS = (((128, 64), (64,)), ((128, 64), (64,)))
OPTION_GRID = [("concat", dict(cost_volume_corr_func="concat")),
               ("cosine", dict(cost_volume_corr_func="cosine")),
               ("max_cost", dict(max_cost=True)),
               ("backward_fc", dict(backward_fc=True))] + [
    (f"head {corr}{' pos' if pos else ''}", dict(pose_head_mlps=HEAD_MLPS, head_corr_func=corr,
                                                 head_pos_embedding=pos))
    for corr in ("concat", "diff", "normalized_diff") for pos in (False, True)]


def efgh_intrinsic():
    """The raw camera resized to 352x1216, as the loader scales it."""
    import numpy as np

    k = np.array(RAW_K, np.float64)
    k[0] *= EFGH_W / RAW_HW[1]
    k[1] *= EFGH_H / RAW_HW[0]
    return k.astype(np.float32)


def drive_cloud(rng, count: int):
    """`count` camera-frame points at the ranges of a KITTI raw scan after
    the raw loader's filter (ahead of the sensor): ranges 5-80 m, 15% of
    them 80-120 m (the HDL-64E's reach), azimuth within 80 deg of the
    optical axis, elevation -25 to +3 deg, depth over 2 m."""
    import numpy as np

    m = 2 * count
    r = np.where(rng.uniform(size=m) < 0.85, rng.uniform(5, 80, m), rng.uniform(80, 120, m))
    az = rng.uniform(-1, 1, m) * np.radians(80)
    el = rng.uniform(np.radians(-25), np.radians(3), m)
    pts = np.stack([r * np.cos(el) * np.sin(az), -r * np.sin(el), r * np.cos(el) * np.cos(az)], -1)
    pts = pts[pts[:, 2] > 2]
    check(len(pts) >= count, f"drive_cloud: {len(pts)} points ahead, {count} wanted")
    return pts[:count].astype(np.float32)


def efgh_inputs(points: int, device, near: bool = False):
    """(rgb, camera-frame cloud, K, calib = [K | 0]) at B=8, 352x1216, from
    numpy with seed 0: the online-calibration loader's frame and matrix;
    the cloud at a raw drive's ranges (``drive_cloud``), or with ``near``
    within 10 m of a point 20 m ahead (depths 10-30 m)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    rgb = rng.normal(size=(BATCH, EFGH_H, EFGH_W, 3)).astype(np.float32)
    if near:
        lidar = rng.uniform(-10, 10, size=(BATCH, points, 3)).astype(np.float32)
        lidar[..., 2] += 20.0
    else:
        lidar = np.stack([drive_cloud(rng, points) for _ in range(BATCH)])
    k = np.tile(efgh_intrinsic()[None], (BATCH, 1, 1))
    calib = np.concatenate([k, np.zeros((BATCH, 3, 1), np.float32)], -1)
    return tuple(torch.from_numpy(a).to(device) for a in (rgb, lidar, k, calib))


def identity_gt(batch: dict, device) -> dict:
    import torch

    return dict(batch, decalib_q_gt=torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=device)
                .repeat(BATCH, 1), decalib_t_gt=torch.zeros(BATCH, 3, device=device))


def check_step_moved(model, params0, buffers0, metrics, label: str) -> None:
    """A finite loss; every parameter and BatchNorm statistic moved."""
    import torch

    check(all(bool(torch.isfinite(v).all()) for v in metrics.values()),
          f"{label}: metrics {({k: float(v) for k, v in metrics.items()})}")
    unmoved = [n for n, p in model.named_parameters() if torch.equal(p.detach(), params0[n])]
    check(not unmoved, f"{label}: parameters unchanged by a step: {unmoved[:5]}")
    unmoved = [n for n, b in model.named_buffers() if torch.equal(b, buffers0[n])]
    check(not unmoved, f"{label}: statistics unchanged by a step: {unmoved[:5]}")


def timed_step(step, state, batch, gen, label: str, card: str) -> None:
    """The step's ms (median of 3 windows of STEP_ITERS steps, CUDA events)."""
    import torch

    losses = []
    ms, spread = windows_ms(lambda: losses.append(step(state, batch, gen)["loss"]), STEP_ITERS)
    check(bool(torch.isfinite(torch.stack(losses)).all()), f"{label}: a step's loss is not finite")
    print(f"{label}: {ms:.3f} ms/step, {BATCH * 1000.0 / ms:.2f} pairs/s (B={BATCH}, median of "
          f"{WINDOWS}x{STEP_ITERS}, spread {spread:.1f}%) on {card}")


def print_cv1_scale(label: str, calls) -> None:
    (args, out), = calls
    t_pi, e_pi = (float(a.abs().max()) for a in args[1:3])
    print(f"phase 21 cv1, {label}: K={args[3].shape[1]} pixels, max |t_pi| {t_pi:.1f}, max "
          f"|e_pi| {e_pi:.1f} (depth-restored feature-pixel coordinates), max |out| "
          f"{float(out.abs().max()):.3f}")


def cv1_exact(pn, t_pi, e_pi, qn, t_qi, e_qi, w1c, w2, b2, w3, b3, v1a, v1b, v1, v2, v2b):
    """cv1_plain's chain in f64 with none of its bf16 rounding points: the
    function that the kernel and its plain version both approximate."""
    import torch

    f, leaky = (lambda x: x.double()), (lambda x: torch.maximum(x, 0.1 * x))
    corr = f(qn)[:, None, :, :] * f(pn)[:, :, None, :]
    h1 = leaky(corr @ f(w1c) + f(t_qi)[:, None] + f(t_pi)[:, :, None])
    h3 = leaky(leaky(h1 @ f(w2) + f(b2)) @ f(w3) + f(b3))
    e = leaky(f(e_qi)[:, None] + f(e_pi)[:, :, None])
    g2 = leaky(leaky(e @ f(v1a) + h3 @ f(v1b) + f(v1)) @ f(v2) + f(v2b))
    w = torch.exp(g2 - torch.amax(g2, dim=2, keepdim=True))
    return torch.sum(w * h3, dim=2) / torch.sum(w, dim=2)


def cv1_at_drive_scale(cv_module, calls) -> float:
    """Hold cv1 at a raw drive's ranges, where t_pi and e_pi reach the
    thousands and the chain's bf16 rounding points lose absolute precision
    with them: the kernel within 1/256 of max |plain| (one bf16 step at the
    output's largest magnitude) of its plain version, and no further from
    the exact f64 chain than the plain version is (5% and 5e-3 of slack).
    Returns the max abs error against the plain version."""
    (args, got), = calls
    ref = cv_module.cv1_plain(*args)
    exact = cv1_exact(*args)
    err = float((got.float() - ref).abs().max())
    scale = float(ref.abs().max())
    k_exact = float((got.double() - exact).abs().max())
    p_exact = float((ref.double() - exact).abs().max())
    del exact
    print_cv1_scale("a raw drive's ranges", calls)
    print(f"phase 21 cv1: max abs err {err:.3e} against the plain version (max |out| {scale:.3f}, "
          f"bar {max(scale, 1.0) / 256:.3e}); against the exact f64 chain: kernel {k_exact:.3e}, "
          f"plain {p_exact:.3e}")
    check(err <= max(scale, 1.0) / 256, f"cv1 at drive ranges: {err} > max|ref|/256")
    check(k_exact <= 1.05 * p_exact + 5e-3,
          f"cv1 at drive ranges: {k_exact} from the exact chain, the plain version {p_exact}")
    return err


def efgh_phase(ctx, work: str) -> None:
    """Phase 21: the efgh model (the shipped config with efgh, bf16, B=8,
    352x1216, 8192 points at a raw drive's ranges, calib = the resized K @
    [I|0]): the eval forward (FPS 4, encoder block 15, cv1 1, every call
    against its plain version, a repeat identical, eager and
    graph-replayed times), a 2-stage Evaluator cascade threading calib and
    its throughput with no capture on, and the train step. Returns each
    kernel's max abs error against its plain version there."""
    import torch

    from i2pnet_tpu_torch.config import I2PNetConfig
    from i2pnet_tpu_torch.data import BatchLoader
    from i2pnet_tpu_torch.data.pipeline import prefetch_to_device
    from i2pnet_tpu_torch.eval import Evaluator
    from i2pnet_tpu_torch.models import I2PNet, init_random_
    from i2pnet_tpu_torch.train import create_train_state, make_train_step

    cfg = dataclasses.replace(I2PNetConfig(), efgh=True, compute_dtype="bfloat16")
    model = init_random_(I2PNet(cfg), torch.Generator().manual_seed(SEED)).eval()
    rgb, lidar, k, calib = efgh_inputs(cfg.lidar_in_points, ctx.dev)

    def forward():
        return model(rgb, lidar, k, calib=calib)

    errors = {}
    with torch.no_grad():
        with Captures(ctx.eval_kernels) as caps:
            out = ctx.launches_of("efgh_eval", FREE_VAL_LAUNCHES, forward)
        out2 = forward()
        torch.cuda.synchronize()
        check_outputs(out, out2, "phase 21 efgh eval")
        for kern in ctx.eval_kernels[:2]:
            errors[kern["name"]] = eval_kernel_error(
                kern["name"], getattr(kern["module"], kern["plain"]), caps[kern["name"]].calls)
        errors["cv1"] = cv1_at_drive_scale(ctx.cv1["module"], caps["cv1"].calls)
        # depths of 10-30 m: cv1 within its absolute bar (not a counted run)
        near = efgh_inputs(cfg.lidar_in_points, ctx.dev, near=True)
        with Capture(ctx.cv1["module"], ctx.cv1["fn"]) as cap:
            model(near[0], near[1], near[2], calib=near[3])
        eval_kernel_error("cv1", ctx.cv1["module"].cv1_plain, cap.calls)
        print_cv1_scale("depths 10-30 m", cap.calls)
        del caps, cap, near
        fwd_ms, spread = windows_ms(forward)
        graph_ms = cuda_ms(graph_of(forward).replay, ITERS)
    print(f"phase 21 efgh forward: {fwd_ms:.3f} ms/batch eager ({BATCH * 1000.0 / fwd_ms:.2f} "
          f"pairs/s, spread {spread:.1f}%), {graph_ms:.3f} ms/batch under CUDA-graph replay "
          f"({BATCH * 1000.0 / graph_ms:.2f} pairs/s) at B={BATCH}, {EFGH_H}x{EFGH_W} on "
          f"{ctx.card}")
    del model, out, out2

    # the 2-stage Evaluator cascade, calib threaded through both stages
    ds = FreeEvalDataset(EFGH_STAGE_BATCHES * BATCH, cfg.lidar_in_points, seed=SEED + 4, efgh=True)
    models = [init_random_(I2PNet(cfg), torch.Generator().manual_seed(SEED + i)).eval()
              for i in range(EVAL_STAGES)]
    log_dir = os.path.join(work, "efgh_eval")
    evaluator = Evaluator(models, cfg, proj=False, log_dir=log_dir)
    with CascadeRecorder() as rec:
        summary = ctx.launches_of(
            "efgh_evaluator", EFGH_EVALUATOR_LAUNCHES,
            lambda: evaluator.validate(BatchLoader(ds, BATCH, shuffle=False, drop_last=False)))
    check_eval_outputs(summary, log_dir, len(ds), "phase 21 efgh Evaluator")
    check_cascade(models, next(prefetch_to_device([collate_first(ds)], ctx.dev)), False,
                  rec.outs[0], "phase 21")
    print(f"phase 21: Evaluator, a {EVAL_STAGES}-stage efgh cascade (calib to both stages) in bf16 "
          f"at B={BATCH}, {EFGH_H}x{EFGH_W}: {len(ds)} pairs, the checks' recorder on")
    del evaluator, rec
    evaluator_throughput(ctx.launches_of, "efgh_evaluator_timed", EFGH_TIMED_LAUNCHES, models,
                         cfg, False, Repeated(ds, EFGH_EVAL_REPEATS),
                         os.path.join(work, "efgh_timed"))
    del models, ds

    # the train step: bf16, dropout, Adam, on the train-encoder kernels
    tmodel = init_random_(I2PNet(cfg), torch.Generator().manual_seed(SEED))
    state = create_train_state(tmodel, steps_per_epoch=100)
    step, gen = make_train_step(tmodel, cfg), torch.Generator(ctx.dev).manual_seed(SEED)
    batch = identity_gt({"rgb": rgb, "lidar": lidar, "intrinsic": k, "calib": calib}, ctx.dev)
    params0 = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    buffers0 = {n: b.clone() for n, b in tmodel.named_buffers()}
    with Captures(ctx.train_kernels) as caps:
        metrics = ctx.launches_of("efgh_train", TRAIN_LAUNCHES, lambda: step(state, batch, gen))
    check_step_moved(tmodel, params0, buffers0, metrics, "phase 21 efgh train step")
    errors.update(hold_train_calls(ctx, caps, f"phase 21 ({EFGH_H}x{EFGH_W})"))
    del caps, params0, buffers0
    print(f"phase 21 efgh train step: loss {float(metrics['loss']):.6f}; every parameter and "
          f"statistic moved")
    timed_step(step, state, batch, gen, "phase 21 efgh train step", ctx.card)
    return errors


def mask_phase(ctx, inputs, work: str) -> None:
    """Phase 22: the projection-mask branch at the bench shape (B=8,
    384x1280, 8192 points, bf16): a train step with train_target='all',
    2-step Trainer epochs with train_target='class' (model_acc_best, the
    mask accuracy finite), a step of the mask_sigmoid variant, and the
    eval-time gt-mask fallback forward."""
    import math

    import torch

    from i2pnet_tpu_torch.config import I2PNetConfig
    from i2pnet_tpu_torch.models import I2PNet, init_random_
    from i2pnet_tpu_torch.train import create_train_state, make_train_step
    from i2pnet_tpu_torch.train.trainer import Trainer

    base = dataclasses.replace(I2PNetConfig(), compute_dtype="bfloat16", **MASK_CFG)
    rgb, lidar, k = inputs
    batch = identity_gt({"rgb": rgb, "lidar": lidar, "intrinsic": k}, ctx.dev)
    for label, cfg in (("all", base), ("sigmoid", dataclasses.replace(
            base, mask_sigmoid=True, ground_truth_mask_layer=(False, False)))):
        model = init_random_(I2PNet(cfg), torch.Generator().manual_seed(SEED))
        state = create_train_state(model, steps_per_epoch=100)
        step, gen = make_train_step(model, cfg), torch.Generator(ctx.dev).manual_seed(SEED)
        params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        buffers0 = {n: b.clone() for n, b in model.named_buffers()}
        metrics = ctx.launches_of(f"mask_train_{label}", TRAIN_LAUNCHES,
                                  lambda: step(state, batch, gen))
        check(float(metrics["loss_mask"]) > 0,
              f"phase 22 {label}: loss_mask {float(metrics['loss_mask'])}")
        check_step_moved(model, params0, buffers0, metrics, f"phase 22 mask step ({label})")
        print(f"phase 22 mask step ({label}): loss {float(metrics['loss']):.6f}, loss_mask "
              f"{float(metrics['loss_mask']):.6f}; every parameter and statistic moved")
        if label == "all":
            timed_step(step, state, batch, gen, "phase 22 mask train step (all)", ctx.card)
        del model, state, step, params0, buffers0

    # the Trainer on the mask-only loss: 2 epochs of 2 steps, a validation
    # batch each; the mask accuracy is the only best
    model = init_random_(I2PNet(base), torch.Generator().manual_seed(SEED))
    log_dir = os.path.join(work, "mask_class")
    trainer = Trainer(model, base, FreeEvalDataset(2 * BATCH, base.lidar_in_points, SEED + 5),
                      FreeEvalDataset(BATCH, base.lidar_in_points, SEED + 6), log_dir=log_dir,
                      batch_size=BATCH, epochs=2, save_rate=1, train_target="class",
                      device="cuda")
    ctx.launches_of("mask_trainer_class", run_launches(TRAIN_LAUNCHES, FREE_VAL_LAUNCHES, 4, 2),
                    trainer.train)
    acc = trainer.best["acc"]
    check(trainer.ckpt.has_best("model_acc_best") and math.isfinite(acc) and 0 <= acc <= 1
          and not trainer.ckpt.has_best("model_rotation_best"),
          f"phase 22 Trainer class: best {trainer.best}")
    losses = [v for _, v in scalars(log_dir, "train/loss")]
    epoch_s = dict(scalars(log_dir, "train/epoch_time_s"))[1]
    check(len(losses) == 4 and all(math.isfinite(v) for v in losses), f"phase 22 losses {losses}")
    print(f"phase 22: Trainer, train_target='class', 2 epochs of 2 steps: mask losses "
          f"{[round(v, 4) for v in losses]}, validation acc {acc:.4f}, model_acc_best written; "
          f"epoch 1 {epoch_s * 1e3 / 2:.1f} ms a step with the loading on {ctx.card}")
    del trainer, model

    # the eval-time fallback of a gt-mask-trained model: no l3 head, the
    # labels of the coarse pose stand in for the mask
    fcfg = dataclasses.replace(I2PNetConfig(), compute_dtype="bfloat16", layer_mask=(False, False))
    model = init_random_(I2PNet(fcfg), torch.Generator().manual_seed(SEED)).eval()
    with torch.no_grad():
        out = ctx.launches_of("mask_fallback_eval", FREE_VAL_LAUNCHES, lambda: model(*inputs))
        out2 = model(*inputs)
    check_outputs(out, out2, "phase 22 gt-mask fallback")
    pm3 = out["pm3"][0]
    check(pm3.shape == (BATCH, fcfg.lidar_layer_points[2], 2)
          and bool(((pm3 == 0) | (pm3 == 1)).all()) and bool((pm3.sum(-1) == 1).all()),
          "phase 22: the fallback's pm3 is not one-hot")
    print(f"phase 22: the gt-mask fallback forward: pm3 one-hot, {float(pm3[..., 1].mean()):.3f} "
          f"of the l3 points in the frustum")


def option_grid(ctx, inputs) -> None:
    """Phase 23: eval forwards of the shipped config in bf16 at the bench
    shape with each cost-volume option and each pose-head option; cv1
    launches only where JAX fuses (the pose-head options), none on the
    concat, cosine, max_cost and backward_fc cost volumes."""
    import torch

    from i2pnet_tpu_torch.config import I2PNetConfig
    from i2pnet_tpu_torch.models import I2PNet, init_random_

    for label, kw in OPTION_GRID:
        cfg = dataclasses.replace(I2PNetConfig(), compute_dtype="bfloat16", **kw)
        model = init_random_(I2PNet(cfg), torch.Generator().manual_seed(SEED)).eval()
        fused = not label.startswith(("concat", "cosine", "max_cost", "backward_fc"))
        want = dict(FREE_VAL_LAUNCHES, cv1=1 if fused else 0)
        t0 = time.perf_counter()
        with torch.no_grad():
            out = ctx.launches_of(f"options {label}", want, lambda: model(*inputs))
        ms = (time.perf_counter() - t0) * 1e3
        check(all(bool(torch.isfinite(out[key]).all()) for key in ("out3", "out4")),
              f"phase 23 {label}: out3/out4 not finite")
        check(model.cost_volume1.fuses_cv1() == fused, f"phase 23 {label}: the cv1 gate")
        print(f"phase 23 {label}: out3/out4 finite, cv1 {want['cv1']}; first forward {ms:.1f} ms "
              f"on {ctx.card}")
        del model, out


# phases 24-26: the vehicle-localisation protocols on trees written with
# numpy. The script assumes no h5py or PIL, so each phase stands in for
# the one function of its loader that reads a local map (h5py) and, on
# nuScenes, the one that decodes a camera frame (PIL): the phase writes
# those files with numpy under the names the loaders look for, and its
# stand-ins read them back with np.load. Everything else is the port's own
# code: the loaders' sampling, decalibration, crop, resize and
# normalisation, load_test_rt, BatchLoader and the pinned prefetch, the CLIs
# and their factories, the Trainer, the Evaluator and the checkpoints.
CMR_FRAMES = {3: 24, 0: 16}  # KITTI odometry sequence 03 (training) and 00 (test)
CMR_MAP_POINTS = 120000
CMR_STEPS = 2 * (CMR_FRAMES[3] // BATCH)  # 2 epochs of 3 steps
CMR_SEEDS = tuple(range(10))
CMR_TEST_BATCHES = CMR_FRAMES[0] // BATCH
CMR_TIMED_REPEATS = 6
NUS_ENTRIES, NUS_FRAME = 16, (900, 1600, 3)
NUS_LARGE_POINTS, NUS_CMR_POINTS = (100000, 150000), (50000, 80000)
# nuScenes' CAM_FRONT camera; LIDAR_TOP (x right, y ahead, z up) to the
# camera (x right, y down, z ahead), 0.3 m below and 0.7 m behind it
NUS_K = ((1266.417, 0.0, 816.267), (0.0, 1266.417, 491.507), (0.0, 0.0, 1.0))
NUS_VELO2CAM = ((1.0, 0.0, 0.0, 0.0), (0.0, 0.0, -1.0, -0.3), (0.0, 1.0, 0.0, -0.7),
                (0.0, 0.0, 0.0, 1.0))
NUS_EVALUATOR_LAUNCHES = {k: v * EVAL_STAGES * (NUS_ENTRIES // BATCH)
                          for k, v in PROJ_VAL_LAUNCHES.items()}
KERNEL_KEYS = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def read_npz_map(path: str):
    """Stands in for ``data/kitti_odometry_cmr.py`` ``read_local_map`` (h5py):
    the map's 'PC' rows 0-2 and its 'intensity', from an npz written under
    the map's .h5 name."""
    import numpy as np

    with np.load(path) as z:
        return z["PC"][:3].astype(np.float32), z["intensity"].astype(np.float32)


def read_npy_frame(path: str):
    """Stands in for ``data/nuscenes.py`` ``read_image`` (PIL) where PIL is
    not installed: the uint8 frame, from an .npy written under the frame's
    .jpg name."""
    import numpy as np

    return np.load(path)


def pil_decodes() -> bool:
    """Whether nuScenes' ``read_image`` runs here (PIL installed)."""
    import importlib.util

    return importlib.util.find_spec("PIL") is not None


def write_frame(path: str, frame, written: list) -> None:
    """A camera frame under the loader's .jpg name: a PNG (``write_png``)
    where PIL decodes it (PIL reads by content, not by name), else an .npy
    for ``read_npy_frame``; (path, frame) appended to ``written`` (``check_decoded_frames``)."""
    import numpy as np

    from i2pnet_tpu_torch.eval.visualize import write_png

    if pil_decodes():
        write_png(path, frame)
    else:
        with open(path, "wb") as f:
            np.save(f, frame)
    written.append((path, frame))


def check_decoded_frames(written: list, label: str) -> None:
    """Every frame written, read back by nuScenes' own ``read_image``, equal
    to the array written (where PIL is installed)."""
    import numpy as np

    from i2pnet_tpu_torch.data import nuscenes

    if not pil_decodes():
        print(f"{label}: no PIL here; the frames are .npy read by read_npy_frame")
        return
    for path, frame in written:
        check(np.array_equal(nuscenes.read_image(path), frame),
              f"{label}: {path} decoded by read_image differs from the array written")
    print(f"{label}: {len(written)} PNG frames {written[0][1].shape} under .jpg names, each "
          f"decoded by nuscenes.read_image (PIL) equal to the array written")


class StandIns:
    """The map read (and, with ``frames`` where PIL is not installed,
    nuScenes' frame decode) replaced by ``read_npz_map`` /
    ``read_npy_frame`` while active."""

    def __init__(self, label: str, frames: bool = False):
        self.label, self.frames = label, frames and not pil_decodes()

    def __enter__(self):
        from i2pnet_tpu_torch.data import kitti_odometry_cmr, nuscenes

        self.saved = [(kitti_odometry_cmr, "read_local_map", read_npz_map)]
        if self.frames:
            self.saved.append((nuscenes, "read_image", read_npy_frame))
        self.saved = [(m, name, getattr(m, name), new) for m, name, new in self.saved]
        for m, name, _, new in self.saved:
            setattr(m, name, new)
        names = " and ".join(f"{m.__name__.split('.')[-1]}.{name}" for m, name, _, _ in self.saved)
        print(f"{self.label} stands in for {names} (h5py{' and PIL' if self.frames else ''}, "
              f"which the script does not assume installed): the files were written with numpy "
              f"under the loader's names and are read with np.load; the rest of the loader is "
              f"the port's")
        return self

    def __exit__(self, *exc):
        for m, name, old, _ in self.saved:
            setattr(m, name, old)


def street_map(rng, count: int, low: float = 5.0, high: float = 60.0):
    """(3, count) f32 points of a street around a car in the KITTI velodyne
    frame (x ahead, y left, z up), horizontal ranges low-high m: the road
    1.73 m below the sensor (45%), facades 6-12 m to either side up to 9 m
    high (45%), poles and parked cars between (10%)."""
    import numpy as np

    m = 3 * count
    kind = rng.uniform(size=m)
    x = rng.uniform(-high, high, m)
    side = np.where(rng.uniform(size=m) < 0.5, -1.0, 1.0)
    y = np.where(kind < 0.45, rng.uniform(-12, 12, m),
                 side * np.where(kind < 0.9, rng.uniform(6, 12, m), rng.uniform(2.5, 6, m)))
    z = np.where(kind < 0.45, -1.73 + rng.normal(0, 0.03, m),
                 np.where(kind < 0.9, rng.uniform(-1.73, 7.3, m), rng.uniform(-1.73, 1.5, m)))
    r = np.hypot(x, y)
    pts = np.stack([x, y, z])[:, (r >= low) & (r <= high)]
    check(pts.shape[1] >= count, f"street_map: {pts.shape[1]} points, {count} wanted")
    return pts[:, :count].astype(np.float32)


def write_map(path: str, pc, rng) -> None:
    """A local map ('PC' (4, N) with a row of ones, 'intensity' (1, N)) as
    an npz under ``path``."""
    import numpy as np

    n = pc.shape[1]
    with open(path, "wb") as f:
        np.savez(f, PC=np.vstack([pc, np.ones((1, n), np.float32)]),
                 intensity=rng.uniform(0, 1, (1, n)).astype(np.float32))


def write_cmr_tree(root: str, rt_dir: str) -> None:
    """The KITTI odometry CMR loader's layout: sequences 03 and 00 with
    their local maps (CMR_MAP_POINTS points of a street each), 376x1241
    uint8 frames as .npy and calib.txt; and the 10-seed protocol's per-seed
    pickles (``generate_test_rt`` rows, rx first) at ``cmr_test_rt_path``,
    one a file name: the protocol's tags repeat (0 for every even seed)."""
    import pickle

    import numpy as np

    from i2pnet_tpu_torch.data.preprocess import cmr_test_rt_path, generate_test_rt

    rng = np.random.default_rng(SEED + 24)
    for seq, count in CMR_FRAMES.items():
        seq_dir = os.path.join(root, "kitti_processed_CMRNet", "sequences", "%02d" % seq)
        for sub in ("local_maps", "image_2_npy"):
            os.makedirs(os.path.join(seq_dir, sub))
        with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
            f.write(KITTI_CALIB)
        for fi in range(count):
            write_map(os.path.join(seq_dir, "local_maps", "%06d.h5" % fi),
                      street_map(rng, CMR_MAP_POINTS), rng)
            np.save(os.path.join(seq_dir, "image_2_npy", "%06d.npy" % fi),
                    rng.integers(0, 256, size=(376, 1241, 3), dtype=np.uint8))
    os.makedirs(rt_dir)
    for seed in CMR_SEEDS:
        path = cmr_test_rt_path(rt_dir, "00", 10.0, 2.0, seed)
        if not os.path.exists(path):
            with open(path, "wb") as f:
                pickle.dump(generate_test_rt(CMR_FRAMES[0], seed=seed).tolist(), f)


def write_nus_tree(root: str, points, frames_dir=None) -> str:
    """The nuScenes loaders' layout: NUS_ENTRIES local maps (``points``, a
    (low, high) count each, of a street in LIDAR_TOP's frame), CAM_FRONT
    frames of 900x1600x3 uint8 under .jpg names (``write_frame``; written unless
    ``frames_dir`` holds them: absolute camera paths, as the split lists
    keep them), and train_dataset0.list / test_dataset0.list over the same
    entries, ((map_relpath, cam_path), K, velo2cam2, meta). Returns the
    frames' directory."""
    import pickle

    import numpy as np

    rng = np.random.default_rng(SEED + 25 + points[0] % 7)
    os.makedirs(os.path.join(root, "maps"))
    write_frames = frames_dir is None
    frames_dir = frames_dir or os.path.join(root, "samples", "CAM_FRONT")
    os.makedirs(frames_dir, exist_ok=True)
    entries, written = [], []
    for i in range(NUS_ENTRIES):
        pc = street_map(rng, int(rng.integers(points[0], points[1] + 1)))
        write_map(os.path.join(root, "maps", f"{i}.h5"), np.stack([-pc[1], pc[0], pc[2]]), rng)
        cam = os.path.join(frames_dir, f"{i}.jpg")
        if write_frames:
            write_frame(cam, rng.integers(0, 256, size=NUS_FRAME, dtype=np.uint8), written)
        entries.append(((f"maps/{i}.h5", cam), np.array(NUS_K), np.array(NUS_VELO2CAM),
                        {"token": f"{i:032x}"}))
    for split in ("train", "test"):
        with open(os.path.join(root, f"{split}_dataset0.list"), "wb") as f:
            pickle.dump(entries, f)
    if written:
        check_decoded_frames(written, "phase 25 nuScenes tree")
    return frames_dir


def shape_rows(ctx, label: str, kernels, captures, launches, errors) -> dict:
    """Each kernel's calls on a new path timed as the table's rows are
    (``kernel_row``: graph replay of the kernel, its plain version and the
    library call, the bound from these inputs): {name: {label: numbers}}."""
    import torch

    with torch.no_grad():
        rows = {k["name"]: kernel_row(k, launches[k["name"]], errors[k["name"]],
                                      captures[k["name"]].calls, ctx.card) for k in kernels}
    return {name: {label: {key: r[key] for key in KERNEL_KEYS}} for name, r in rows.items()}


def merge_rows(rows: dict, part: dict) -> None:
    """Add shape_rows' {name: {label: numbers}} to ``rows``, path by path."""
    for name, entry in part.items():
        rows.setdefault(name, {}).update(entry)


class Captures(dict):
    """A Capture of each kernel, by name, all active together."""

    def __init__(self, kernels):
        super().__init__((k["name"], Capture(k["module"], k["fn"])) for k in kernels)

    def __enter__(self):
        for cap in self.values():
            cap.__enter__()
        return self

    def __exit__(self, *exc):
        for cap in self.values():
            cap.__exit__(*exc)


def forward_and_replay(fwd, label: str, card: str):
    """fwd() twice eagerly (out3 identical, checked by check_outputs) and
    captured in a CUDA graph replayed twice (out3 identical); prints the
    eager and replayed times and whether the replay equals the eager out3."""
    import torch

    with torch.no_grad():
        out, out2 = fwd(), fwd()
        torch.cuda.synchronize()
        check_outputs(out, out2, label)
        held = {}
        graph = graph_of(lambda: held.__setitem__("out", fwd()))
        graph.replay()
        r1 = held["out"]["out3"].clone()
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(r1, held["out"]["out3"]), f"{label}: two graph replays differ")
        gap = float((r1 - out["out3"]).abs().max())
        eager_ms, spread = windows_ms(fwd)
        graph_ms = cuda_ms(graph.replay, ITERS)
    print(f"{label}: two replays of its CUDA graph bit-identical; replay against the eager out3: "
          f"max abs {gap:.3e}{' (equal)' if gap == 0 else ''}")
    print(f"{label} forward: {eager_ms:.3f} ms/batch eager ({BATCH * 1000.0 / eager_ms:.2f} "
          f"pairs/s, spread {spread:.1f}%), {graph_ms:.3f} ms/batch under CUDA-graph replay "
          f"({BATCH * 1000.0 / graph_ms:.2f} pairs/s) at B={BATCH} on {card}")
    return out


def hold_train_calls(ctx, caps, label: str) -> dict:
    """Every train-kernel call of a step against its plain version (phase 6's
    bars); FPS exactly. Returns each kernel's worst error."""
    import torch

    errors = {}
    with torch.no_grad():
        for k in ctx.train_kernels:
            errors[k["name"]] = train_kernel_error(
                k["name"], getattr(k["module"], k["fn"]), getattr(k["module"], k["plain"]),
                caps[k["name"]].calls)
            print(f"{label} {k['name']}: {len(caps[k['name']].calls)} calls match the plain "
                  f"version, max abs err {errors[k['name']]:.3e}")
        if "fps" in caps:
            errors["fps"] = eval_kernel_error("fps", ctx.fps["module"].fps_plain, caps["fps"].calls)
    return errors


def knn_ties(calls, label: str) -> None:
    """Every knn_point call against the int64-key top-k over its whole row
    (``knn_by_key``) on the same distances: equal, index for index; prints
    how many queries had ties across the k-th place."""
    import torch

    from i2pnet_tpu_torch.ops import pointops

    straddle = 0
    with torch.no_grad():
        for (k, xyz, q), got in calls:
            d = pointops.square_distance(q, xyz)
            check(torch.equal(got, pointops.knn_by_key(k, d)),
                  f"{label}: knn_point({k}, {tuple(xyz.shape)}, {tuple(q.shape)}) differs from "
                  f"the key top-k")
            if k < d.shape[-1]:
                near = torch.topk(d, k + 1, dim=-1, largest=False).values
                straddle += int((near[..., k - 1] == near[..., k]).sum())
    print(f"{label}: {len(calls)} knn_point calls equal to the int64-key top-k over each row; "
          f"{straddle} queries with ties across the k-th place")


def cmr_phase(ctx, work: str) -> dict:
    """Phase 24: the KITTI odometry small-range protocol with train_torch.py's
    defaults (kd_cmr_snr, i2pnet) in bf16 at B=8: 2 epochs of 3 steps on
    sequence 03, then scripts/cmr_test_torch.sh's 10-seed protocol in
    process over sequence 00 (evaluate_torch.py, each seed's pickle read by
    load_test_rt), aggregate_seeds over the ten prediction files, and the
    Evaluator's throughput on seed 0's split repeated."""
    import math

    import torch

    import evaluate_torch
    import train_torch
    from i2pnet_tpu_torch import cli
    from i2pnet_tpu_torch.data import KittiOdometryCMRDataset
    from i2pnet_tpu_torch.data.preprocess import cmr_seed_value, cmr_test_rt_path, load_test_rt
    from i2pnet_tpu_torch.eval.analysis import aggregate_seeds, parse_prediction_file
    from i2pnet_tpu_torch.models import I2PNet
    from i2pnet_tpu_torch.train.checkpoint import restore_inference_variables

    root, rt_dir = os.path.join(work, "cmr_data"), os.path.join(work, "cmr_test_rt")
    t0 = time.perf_counter()
    write_cmr_tree(root, rt_dir)
    print(f"phase 24: wrote the KITTI odometry CMR tree ({sum(CMR_FRAMES.values())} frames, maps "
          f"of {CMR_MAP_POINTS} points) and {len(CMR_SEEDS)} per-seed tables in "
          f"{time.perf_counter() - t0:.1f} s")
    defaults = train_torch.parse_args([])
    check((defaults.dataset, defaults.network) == ("kd_cmr_snr", "i2pnet"),
          f"phase 24: train_torch.py's defaults {defaults.dataset}, {defaults.network}")
    log_dir = os.path.join(work, "cmr_run")
    argv = ["--root_path", root, "--log_dir", log_dir, "--compute_dtype", "bfloat16",
            "--batch_size", str(BATCH), "--max_epoch", "2"]
    initial, real_build = {}, cli.build

    def build(args):
        model, cfg, proj = real_build(args)
        initial.setdefault("state", {k: v.clone() for k, v in model.state_dict().items()})
        return model, cfg, proj

    cli.build = build
    try:
        with StandIns("phase 24"), FirstCalls({"step": [ctx.fps] + ctx.train_kernels, "eval": []},
                                              ctx.read_counts) as first:
            trainer = ctx.launches_of("cmr_train_cli",
                                      run_launches(TRAIN_LAUNCHES, NO_LAUNCHES, CMR_STEPS, 0),
                                      lambda: train_torch.main(argv))
    finally:
        cli.build = real_build
    check_first_calls(first, TRAIN_LAUNCHES, None, "phase 24")
    del first
    losses = scalars(log_dir, "train/loss")
    final = trainer.model.state_dict()
    unmoved = [k for k, v in initial["state"].items() if torch.equal(v, final[k])]
    check(isinstance(trainer.train_loader.dataset, KittiOdometryCMRDataset)
          and trainer.valid_loader is None and trainer.state.step == CMR_STEPS
          and losses and all(math.isfinite(v) for _, v in losses) and not unmoved
          and trainer.ckpt.all_steps() == [0, 1],
          f"phase 24: step {trainer.state.step}, losses {losses}, unmoved {unmoved[:5]}, "
          f"checkpoints {trainer.ckpt.all_steps()}")
    cfg = trainer.cfg
    print(f"phase 24: train_torch.py with its defaults, 2 epochs of {CMR_STEPS // 2} steps on "
          f"sequence 03 ({BATCH}x{IMG_H}x{IMG_W}, {cfg.lidar_in_points} points): losses "
          f"{[round(v, 4) for _, v in losses]}, every parameter and statistic moved, no "
          f"validation split, checkpoints {trainer.ckpt.all_steps()}")
    del trainer, initial, final

    # scripts/cmr_test_torch.sh's protocol: one evaluate_torch.py run a seed
    eval_dir = os.path.join(work, "cmr_eval")
    want = run_launches(NO_LAUNCHES, FREE_VAL_LAUNCHES, 0, CMR_TEST_BATCHES)
    t0 = time.perf_counter()
    with StandIns("phase 24 (10 seeds)"):
        for seed in CMR_SEEDS:
            seed_argv = ["--dataset", "kd_cmr_snr", "--network", "i2pnet", "--root_path", root,
                         "--model_dir", log_dir, "--log_dir", eval_dir, "--seed", str(seed),
                         "--tag", f"_seed{seed}", "--compute_dtype", "bfloat16", "--batch_size",
                         str(BATCH), "--test_rt", cmr_test_rt_path(rt_dir, "00", 10.0, 2.0, seed)]

            def run():
                return ctx.launches_of(f"cmr_eval_seed{seed}", want,
                                       lambda: evaluate_torch.main(seed_argv))

            if seed == 0:  # the first run's kernel calls and out3 kept
                with Captures(ctx.eval_kernels) as caps, CascadeRecorder() as rec:
                    summary = run()
            else:
                summary = run()
            check_eval_outputs(summary, eval_dir, CMR_FRAMES[0], f"phase 24 seed {seed}",
                               tag=f"_seed{seed}")
    seeds_s = time.perf_counter() - t0
    with torch.no_grad():
        errors = {k["name"]: eval_kernel_error(k["name"], getattr(k["module"], k["plain"]),
                                               caps[k["name"]].calls) for k in ctx.eval_kernels}
    out3 = torch.cat(rec.outs)
    qn = torch.linalg.norm(out3[:, :4], dim=-1)
    check(tuple(out3.shape) == (CMR_FRAMES[0], 7) and bool(torch.isfinite(out3).all())
          and bool(((qn - 1).abs() <= 1e-3).all()), f"phase 24: seed 0's out3 {out3}")
    # each seed decalibrates by its pickle: the same tables where the
    # protocol's tags repeat (the even seeds), others elsewhere
    inits = {s: parse_prediction_file(os.path.join(eval_dir, f"prediction_seed{s}.txt"))["init"]
             for s in CMR_SEEDS}
    tags = {s: cmr_seed_value(s) for s in CMR_SEEDS}
    check(all((tags[a] == tags[b]) == bool((inits[a] == inits[b]).all())
              for a in CMR_SEEDS for b in CMR_SEEDS),
          f"phase 24: the seeds' decalibrations do not follow their tables' tags {tags}")
    agg = aggregate_seeds(os.path.join(eval_dir, "prediction_seed*.txt"))
    check(agg.get("seeds") == len(CMR_SEEDS) and all(math.isfinite(v) for v in agg.values()),
          f"phase 24: aggregate {agg}")
    print(f"phase 24: the 10-seed protocol (evaluate_torch.py a seed, its pickle through "
          f"load_test_rt; {len(set(tags.values()))} distinct tables) in {seeds_s:.1f} s: ten "
          f"prediction files of {CMR_FRAMES[0]} pairs, seed 0's out3 finite with unit "
          f"quaternions; aggregate_seeds {agg}")
    rows = shape_rows(ctx, "cmr_eval_seed0", ctx.eval_kernels, caps,
                      ctx.path_launches["cmr_eval_seed0"], errors)
    del caps, rec

    # the Evaluator's own throughput on seed 0's split, no capture on
    model = I2PNet(cfg)
    model.load_state_dict(restore_inference_variables(log_dir, model, best="latest"), strict=True)
    with StandIns("phase 24 (timed)"):
        ds = KittiOdometryCMRDataset(root, mode="test", seed=0, test_rt=load_test_rt(
            cmr_test_rt_path(rt_dir, "00", 10.0, 2.0, 0)))
        evaluator_throughput(ctx.launches_of, "cmr_evaluator_timed",
                             {k: v * CMR_TEST_BATCHES * CMR_TIMED_REPEATS
                              for k, v in FREE_VAL_LAUNCHES.items()},
                             [model.eval()], cfg, False, Repeated(ds, CMR_TIMED_REPEATS),
                             os.path.join(work, "cmr_timed"))
    return rows


def nus_large_phase(ctx, work: str):
    """Phase 25: nuScenes large-range (nus_corr_nolidar) on
    ``I2PNetProjConfig.nuscenes()`` in bf16 at B=8: the test split's first
    batch through the eager forward and its CUDA-graph replay, the train
    step on the training split's first batch, and a 2-stage Evaluator over
    the 16 test pairs; every select call on the 32-row grid equal to its
    plain version. Returns the new shapes' kernel numbers and the frames'
    directory, which phase 26 reads too."""
    import torch

    import evaluate_torch
    import train_torch
    from i2pnet_tpu_torch import cli
    from i2pnet_tpu_torch.config import I2PNetProjConfig
    from i2pnet_tpu_torch.data import BatchLoader, prefetch_to_device
    from i2pnet_tpu_torch.data.pipeline import to_model_batch
    from i2pnet_tpu_torch.eval import Evaluator
    from i2pnet_tpu_torch.models import I2PNetProj, init_random_
    from i2pnet_tpu_torch.ops import pointops
    from i2pnet_tpu_torch.train import create_train_state, make_train_step_proj

    root = os.path.join(work, "nus_large")
    t0 = time.perf_counter()
    frames = write_nus_tree(root, NUS_LARGE_POINTS)
    print(f"phase 25: wrote the nuScenes tree ({NUS_ENTRIES} maps of {NUS_LARGE_POINTS[0]}-"
          f"{NUS_LARGE_POINTS[1]} points, {NUS_ENTRIES} {NUS_FRAME} frames) in "
          f"{time.perf_counter() - t0:.1f} s")
    cfg = dataclasses.replace(I2PNetProjConfig.nuscenes(), compute_dtype="bfloat16")
    check(cfg.init_H == 32 and cfg.lidar_Hs == (16, 8, 4, 4), f"phase 25: grid {cfg.lidar_Hs}")
    eargs = evaluate_torch.parse_args(["--dataset", "nus_corr_nolidar", "--root_path", root,
                                       "--model_dir", "unused"])
    targs = train_torch.parse_args(["--dataset", "nus_corr_nolidar", "--network",
                                    "i2pnet_proj", "--root_path", root])
    with StandIns("phase 25", frames=True):
        t0 = time.perf_counter()
        test = to_model_batch(next(prefetch_to_device([collate_first(cli.eval_split(eargs, cfg))],
                                                      ctx.dev)))
        load_ms = (time.perf_counter() - t0) * 1e3 / BATCH
        train_ds, valid = cli.build_datasets(targs, cfg)
        tbatch = to_model_batch(next(prefetch_to_device([collate_first(train_ds)], ctx.dev)))
    check(valid is None and tuple(test["lidar"].shape) == (BATCH, 150000, 3)
          and tuple(test["rgb"].shape) == (BATCH, PROJ_H, PROJ_W, 3),
          f"phase 25: batch {tuple(test['lidar'].shape)}, {tuple(test['rgb'].shape)}")
    print(f"phase 25: a test sample loads in {load_ms:.1f} ms on the host (one thread): "
          f"{BATCH} clouds zero-padded to 150000 points, {PROJ_H}x{PROJ_W} crops")

    model = init_random_(I2PNetProj(cfg), torch.Generator().manual_seed(SEED)).eval()

    def fwd():
        return model(test["rgb"], test["lidar"], test["raw_xyz"], test["intrinsic"],
                     lidar_feature=test["lidar_feats"])

    kernels = [ctx.block, ctx.select]
    with torch.no_grad(), Captures(kernels) as caps, Capture(pointops, "knn_point") as knn:
        ctx.launches_of("nus_proj_eval", PROJ_LAUNCHES, fwd)
        # the free model's first level (8192 points, 2048 queries, k=32) on
        # clouds half zero padding, as the loaders pad them
        cloud = test["lidar"][:, :8192].clone()
        cloud[:, 4096:] = 0.0
        pointops.knn_point(32, cloud, cloud[:, ::4].contiguous())
    knn_ties(knn.calls, "phase 25 KNN (the proj forward's cost volumes; a zero-padded first level)")
    del knn
    forward_and_replay(fwd, "phase 25 nuScenes proj eval", ctx.card)
    with torch.no_grad():
        errors = {k["name"]: eval_kernel_error(k["name"], getattr(k["module"], k["plain"]),
                                               caps[k["name"]].calls) for k in kernels}
    grids = sorted({tuple(a[0].shape[1:3]) for a, _ in caps["select"].calls})
    check(max(h for h, _ in grids) == 32, f"phase 25: select grids {grids}")
    print(f"phase 25: {len(caps['select'].calls)} select calls on the range grids {grids} equal "
          f"to the plain version")
    rows = shape_rows(ctx, "nus_proj_eval", kernels, caps, ctx.path_launches["nus_proj_eval"],
                      errors)
    del caps, model

    # the train step: dropout, Adam, the train-encoder kernels
    tmodel = init_random_(I2PNetProj(cfg), torch.Generator().manual_seed(SEED))
    state = create_train_state(tmodel, steps_per_epoch=100)
    step, gen = make_train_step_proj(tmodel, cfg), torch.Generator(ctx.dev).manual_seed(SEED)
    params0 = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    buffers0 = {n: b.clone() for n, b in tmodel.named_buffers()}
    with Captures(ctx.train_kernels) as caps:
        metrics = ctx.launches_of("nus_proj_train", PROJ_TRAIN_LAUNCHES,
                                  lambda: step(state, tbatch, gen))
    check_step_moved(tmodel, params0, buffers0, metrics, "phase 25 nuScenes proj train step")
    hold_train_calls(ctx, caps, "phase 25")
    print(f"phase 25 nuScenes proj train step: loss {float(metrics['loss']):.6f}; every "
          f"parameter and statistic moved")
    del caps, params0, buffers0
    timed_step(step, state, tbatch, gen, "phase 25 nuScenes proj train step", ctx.card)
    del tmodel, state, step

    # a 2-stage Evaluator over the test split
    models = [init_random_(I2PNetProj(cfg), torch.Generator().manual_seed(SEED + i)).eval()
              for i in range(EVAL_STAGES)]
    log_dir = os.path.join(work, "nus_large_eval")
    with StandIns("phase 25 (Evaluator)", frames=True):
        with Captures(kernels) as caps, CascadeRecorder() as rec:
            summary = ctx.launches_of(
                "nus_proj_evaluator", NUS_EVALUATOR_LAUNCHES,
                lambda: Evaluator(models, cfg, proj=True, log_dir=log_dir).validate(
                    BatchLoader(cli.eval_split(eargs, cfg), BATCH, shuffle=False,
                                drop_last=False)))
        first = next(prefetch_to_device([collate_first(cli.eval_split(eargs, cfg))], ctx.dev))
    check_eval_outputs(summary, log_dir, NUS_ENTRIES, "phase 25 Evaluator")
    check_cascade(models, first, True, rec.outs[0], "phase 25")
    with torch.no_grad():
        for k in kernels:
            eval_kernel_error(k["name"], getattr(k["module"], k["plain"]), caps[k["name"]].calls)
    print(f"phase 25: Evaluator, a {EVAL_STAGES}-stage cascade of the nuScenes proj config in "
          f"bf16 over {NUS_ENTRIES} test pairs: mean_fps {summary['mean_fps']:.2f} pairs/s (the "
          f"checks' captures on, one timed batch)")
    return rows, frames


def nus_cmr_phase(ctx, work: str, frames: str) -> dict:
    """Phase 26: nuScenes small-range (nus_cmr_snr) on the shipped free config
    in bf16 at B=8 and the loader's 640x1280, 8192 points from maps of
    50k-80k: the eager forward and its graph replay (cv1 at K = 20x40 =
    800), the train step (the peak memory of the card), and
    evaluate_torch.py with a --test_rt CSV in the reference's
    id,tx,ty,tz,rx,ry,rz layout."""
    import numpy as np
    import torch

    import evaluate_torch
    import train_torch
    from i2pnet_tpu_torch import cli
    from i2pnet_tpu_torch.config import I2PNetConfig
    from i2pnet_tpu_torch.data import prefetch_to_device
    from i2pnet_tpu_torch.data.pipeline import to_model_batch
    from i2pnet_tpu_torch.data.preprocess import generate_test_rt
    from i2pnet_tpu_torch.models import I2PNet, init_random_
    from i2pnet_tpu_torch.train import create_train_state, make_train_step

    root = os.path.join(work, "nus_cmr")
    t0 = time.perf_counter()
    write_nus_tree(root, NUS_CMR_POINTS, frames_dir=frames)
    rt = generate_test_rt(NUS_ENTRIES, seed=SEED + 26)
    csv = os.path.join(work, "nus_test_rt.csv")
    with open(csv, "w") as f:
        f.write("id,tx,ty,tz,rx,ry,rz\n")
        for i, row in enumerate(rt):
            f.write(",".join([str(i)] + [repr(float(v)) for v in (*row[3:], *row[:3])]) + "\n")
    print(f"phase 26: wrote {NUS_ENTRIES} maps of {NUS_CMR_POINTS[0]}-{NUS_CMR_POINTS[1]} points "
          f"(phase 25's frames) and the test table's CSV in {time.perf_counter() - t0:.1f} s")
    cfg = dataclasses.replace(I2PNetConfig(), compute_dtype="bfloat16")
    eargs = evaluate_torch.parse_args(["--dataset", "nus_cmr_snr", "--network", "i2pnet",
                                       "--root_path", root, "--test_rt", csv,
                                       "--model_dir", "unused"])
    targs = train_torch.parse_args(["--dataset", "nus_cmr_snr", "--root_path", root])
    with StandIns("phase 26", frames=True):
        test_ds = cli.eval_split(eargs, cfg)
        check(np.allclose(test_ds.test_RT, rt, rtol=0, atol=1e-15),
              "phase 26: the test table read from the CSV")
        test = to_model_batch(next(prefetch_to_device([collate_first(test_ds)], ctx.dev)))
        tbatch = to_model_batch(next(prefetch_to_device(
            [collate_first(cli.build_datasets(targs, cfg)[0])], ctx.dev)))
    h, w = test["rgb"].shape[1:3]
    check((h, w) == (640, 1280) and tuple(test["lidar"].shape) == (BATCH, 8192, 3),
          f"phase 26: batch {tuple(test['rgb'].shape)}, {tuple(test['lidar'].shape)}")

    model = init_random_(I2PNet(cfg), torch.Generator().manual_seed(SEED)).eval()

    def fwd():
        return model(test["rgb"], test["lidar"], test["intrinsic"],
                     lidar_feature=test["lidar_feats"], raw_xyz=test["raw_xyz"])

    with torch.no_grad(), Captures(ctx.eval_kernels) as caps:
        ctx.launches_of("nus_free_eval", FREE_VAL_LAUNCHES, fwd)
    forward_and_replay(fwd, "phase 26 nuScenes free eval (640x1280)", ctx.card)
    with torch.no_grad():
        errors = {k["name"]: eval_kernel_error(k["name"], getattr(k["module"], k["plain"]),
                                               caps[k["name"]].calls) for k in ctx.eval_kernels}
    (cv1_args, _), = caps["cv1"].calls
    check(cv1_args[3].shape[1] == 800, f"phase 26: cv1 at K={cv1_args[3].shape[1]}")
    blocks = sorted({tuple(a[0].shape[1:3]) for a, _ in caps["encoder_block"].calls})
    print(f"phase 26: cv1 at K={cv1_args[3].shape[1]} (a 20x40 feature grid), max abs err "
          f"{errors['cv1']:.3e}; encoder blocks at {blocks}")
    rows = shape_rows(ctx, "nus_free_eval", ctx.eval_kernels, caps,
                      ctx.path_launches["nus_free_eval"], errors)
    del caps, model

    tmodel = init_random_(I2PNet(cfg), torch.Generator().manual_seed(SEED))
    state = create_train_state(tmodel, steps_per_epoch=100)
    step, gen = make_train_step(tmodel, cfg), torch.Generator(ctx.dev).manual_seed(SEED)
    params0 = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    buffers0 = {n: b.clone() for n, b in tmodel.named_buffers()}
    train_kernels = [ctx.fps] + ctx.train_kernels
    with Captures(train_kernels) as caps:
        metrics = ctx.launches_of("nus_free_train", TRAIN_LAUNCHES,
                                  lambda: step(state, tbatch, gen))
    check_step_moved(tmodel, params0, buffers0, metrics, "phase 26 nuScenes free train step")
    errors = hold_train_calls(ctx, caps, "phase 26")
    print(f"phase 26 nuScenes free train step at {h}x{w}: loss {float(metrics['loss']):.6f}; "
          f"every parameter and statistic moved")
    merge_rows(rows, shape_rows(ctx, "nus_free_train", train_kernels, caps,
                                ctx.path_launches["nus_free_train"], errors))
    del caps, params0, buffers0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    timed_step(step, state, tbatch, gen, f"phase 26 nuScenes free train step ({h}x{w})", ctx.card)
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 26 nuScenes free train step ({h}x{w}): torch.cuda.max_memory_allocated "
          f"{peak / 2**30:.2f} GiB over the timed steps, {(peak - base) / 2**30:.2f} GiB above the "
          f"{base / 2**30:.2f} GiB held before them (model, Adam's state, the batch) on {ctx.card}")
    del tmodel, state, step

    # evaluate_torch.py with the CSV table on a saved single stage
    stage_dirs = save_stages([init_random_(I2PNet(cfg), torch.Generator().manual_seed(SEED))],
                             os.path.join(work, "nus_cmr_stage"))
    eval_dir = os.path.join(work, "nus_cmr_eval")
    with StandIns("phase 26 (evaluate_torch.py)", frames=True):
        summary = ctx.launches_of(
            "nus_cmr_evaluate_cli", run_launches(NO_LAUNCHES, FREE_VAL_LAUNCHES, 0,
                                                 NUS_ENTRIES // BATCH),
            lambda: evaluate_torch.main(["--dataset", "nus_cmr_snr", "--network", "i2pnet",
                                         "--root_path", root, "--test_rt", csv, "--model_dir",
                                         *stage_dirs, "--compute_dtype", "bfloat16",
                                         "--batch_size", str(BATCH), "--log_dir", eval_dir]))
    check_eval_outputs(summary, eval_dir, NUS_ENTRIES, "phase 26 evaluate_torch.py")
    return rows


# phases 27-29: what a user runs around the model. Phase 27 writes the
# seeded models of phases 4 and 10 under the reference's names and layout
# (the inverse of the bridge, kept here), converts them with
# tools/reference_ckpt_to_torch.py and evaluates them with --vis_rate 1 on
# phase 24's KITTI odometry tree (free) and a large-range tree (proj);
# phase 28 renders the demo frames at B=1 (tools/render_demo_torch.py) and
# the real-rig frames (tools/render_real_demo_torch.py); phase 29 builds a
# KITTI odometry sequence and a nuScenes split from raw files that numpy
# writes, with only the h5 writes stood in, and runs a forward on each.
VIS_TAGS = ("init_projected_img", "pj_projected_img", "gt_projected_img", "comparison_img")
LR_FRAMES = {7: 12, 8: 12}  # the proj tree of phases 27-28: three batches
DEMO_FRAMES = 8
REAL_FRAMES, REAL_POINTS, REAL_FRAME = 4, 120000, (1072, 1300, 3)
RAW_FRAMES, RAW_POINTS = 10, 16000
NUS_KEYS, NUS_SWEEP_POINTS = 10, 20000


def tool(name: str):
    """tools/<name>.py of this checkout, imported as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_names(state_dict, proj: bool) -> dict:
    """The inverse of the bridge (``convert.reference_to_state_dict``): the
    port's state_dict under the reference RegNet_v2's names and layouts (the
    RGB encoder's Sequential indices 4 i and 4 i + 1, 1x1 Conv2d weights
    (out, in, 1, 1), the pose heads' Conv1d (out, in, 1), ``bn_linear``)."""
    out = {}
    for name, t in state_dict.items():
        parts = name.split(".")
        head, leaf = parts[0], parts[-1]
        t = t.detach().cpu().clone()
        if head in ("sq", "sx"):
            out[name] = t
            continue
        if head == "rgb_encoder":
            stage, mod = int(parts[1].rsplit("_", 1)[1]), parts[2]
            i = int(mod.rsplit("_", 1)[1])
            out[f"RGB_net{stage + 1}.{4 * i + (not mod.startswith('Conv'))}.{leaf}"] = t
            continue
        if head in ("l3_head", "l4_head"):
            out[f"{head}.{parts[1]}.composed_module.0.{leaf}"] = t[:, :, None] if t.ndim == 2 else t
            continue
        src = head.replace("lidar_lv", "LiDAR_lv")
        if t.ndim == 2:
            t = t[:, :, None, None]
        if not proj and (head.startswith("lidar_lv") or head == "layer_idx"):
            kind = "mlp_convs" if parts[1].startswith("Dense") else "mlp_bns"
            out[f"{src}.{kind}.{parts[1].rsplit('_', 1)[1]}.{leaf}"] = t
            continue
        mid = {"Dense_0": "conv", "BatchNorm_0": "bn_linear", "BatchStatsNorm_0": "bn_linear"}
        out[".".join([src] + [p.rsplit("_", 1)[1] if p.startswith("PointwiseConv_")
                              else mid.get(p, p) for p in parts[1:-1]] + [leaf])] = t
    return out


class VisRecorder:
    """Stands in for ``UniWriter`` on evaluate_torch.py --vis_rate: keeps
    every image call (method, tag, step, array) and whether it was closed."""

    made = []

    def __init__(self, log_dir):
        self.calls, self.closed = [], False
        VisRecorder.made.append(self)

    def add_image(self, tag, img, step):
        self.calls.append(("add_image", tag, step, img))

    def add_images(self, tag, imgs, step):
        self.calls.append(("add_images", tag, step, imgs))

    def close(self):
        self.closed = True


def decode_png(path: str):
    """A PNG as the port's writer writes it (8-bit RGB, filter type 0 on
    every row), decoded with zlib and numpy, each chunk's CRC checked."""
    import struct
    import zlib

    import numpy as np

    data = open(path, "rb").read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        check(struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
              == zlib.crc32(kind + body) & 0xFFFFFFFF, f"{path}: bad CRC on {kind}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, color = header[:4]
    check(depth == 8 and color == 2, f"{path}: bit depth {depth}, colour type {color}")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    check(not rows[:, 0].any(), f"{path}: a row filter other than 0 (not the port's writer)")
    return rows[:, 1:].reshape(h, w, 3)


def first_batch_forward(model, samples, proj: bool, dev):
    """out3 of ``model`` on the first BATCH of ``samples``, as the loader
    collates them."""
    import torch

    from i2pnet_tpu_torch.data import collate, prefetch_to_device
    from i2pnet_tpu_torch.data.pipeline import to_model_batch

    mb = to_model_batch(next(prefetch_to_device([collate(samples[:BATCH])], dev)))
    with torch.no_grad():
        if proj:
            out = model(mb["rgb"], mb["lidar"], mb["raw_xyz"], mb["intrinsic"],
                        lidar_feature=mb["lidar_feats"])
        else:
            out = model(mb["rgb"], mb["lidar"], mb["intrinsic"], lidar_feature=mb["lidar_feats"],
                        raw_xyz=mb["raw_xyz"])
    return out["out3"]


def vis_evaluation(ctx, label, argv, model, proj, kernels, stand_ins, work):
    """evaluate_torch.py --vis_rate 1 on a bridged log dir: the launches
    (the validation batch's a batch), every kernel call against its plain
    version, out3 equal to the seeded model's on the first batch, the four
    tags every batch, the init and gt panels equal to render_projection
    re-run in numpy and the pred panel on the logged out3; then the whole
    pass's pairs/s with and without the overlays. Returns the shapes' rows
    and the prediction file."""
    import math

    import numpy as np
    import torch

    import evaluate_torch
    from i2pnet_tpu_torch.cli import eval_split
    from i2pnet_tpu_torch.eval.visualize import decalib_extrinsic, render_projection
    from i2pnet_tpu_torch.utils import monitor

    eargs = evaluate_torch.parse_args(argv)
    with stand_ins():
        ds = eval_split(eargs, model.cfg)
        samples = [ds[i] for i in range(len(ds))]
    batches = -(-len(samples) // BATCH)
    val = PROJ_VAL_LAUNCHES if proj else FREE_VAL_LAUNCHES
    log_dir = os.path.join(work, f"{label}_eval")
    vis_argv = argv + ["--vis_rate", "1", "--log_dir", log_dir]
    real, VisRecorder.made = monitor.UniWriter, []
    monitor.UniWriter = VisRecorder
    try:
        with stand_ins(), Captures(kernels) as caps, CascadeRecorder() as rec:
            summary = ctx.launches_of(label, run_launches(NO_LAUNCHES, val, 0, batches),
                                      lambda: evaluate_torch.main(vis_argv))
    finally:
        monitor.UniWriter = real
    check_eval_outputs(summary, log_dir, len(samples), f"phase 27 {label}")
    with torch.no_grad():
        errors = {k["name"]: eval_kernel_error(k["name"], getattr(k["module"], k["plain"]),
                                               caps[k["name"]].calls) for k in kernels}
    want = first_batch_forward(model, samples, proj, ctx.dev)
    check(torch.equal(want, rec.outs[0]), f"phase 27 {label}: out3 differs from the seeded "
                                          f"model's on the first batch")
    (writer,) = VisRecorder.made
    steps = [(c[0], c[1], c[2]) for c in writer.calls]
    check(writer.closed and steps == [(m, t, bi) for bi in range(batches) for m, t in zip(
        ("add_image",) * 3 + ("add_images",), VIS_TAGS)], f"phase 27 {label}: writer calls {steps}")
    eye = np.eye(3, 4, dtype=np.float32)
    for bi in range(batches):
        s = samples[bi * BATCH]
        got = {c[1]: c[3] for c in writer.calls if c[2] == bi}
        rgb = np.clip(s["rgb"], 0, 255).astype(np.uint8)
        gt = decalib_extrinsic(s["decalib_real_gt"], s["decalib_dual_gt"])
        out3 = rec.outs[bi][0].cpu().numpy()
        pred = decalib_extrinsic(out3[:4], out3[4:])
        for tag, E in (("init_projected_img", eye), ("gt_projected_img", gt),
                       ("pj_projected_img", pred)):
            check((got[tag] == render_projection(rgb, s["lidar"], E, s["init_intrinsic"])).all(),
                  f"phase 27 {label}: batch {bi}'s {tag} differs from its numpy re-render")
        check(got["comparison_img"].shape == (3, *rgb.shape), f"phase 27 {label}: comparison")
    print(f"phase 27 {label}: evaluate_torch.py --vis_rate 1 over {len(samples)} pairs: the four "
          f"tags at steps 0-{batches - 1}; init, gt and pred panels equal to render_projection "
          f"re-run in numpy (pred on the logged out3); out3 of the first batch equal to the seeded "
          f"model's, bit for bit")
    rows = shape_rows(ctx, label, kernels, caps, ctx.path_launches[label], errors)
    del caps, rec
    rates = {}
    for vis in (True, False):
        extra = ["--vis_rate", "1"] if vis else []
        monitor.UniWriter = VisRecorder
        try:
            with stand_ins():
                t0 = time.perf_counter()
                s2 = evaluate_torch.main(argv + extra + ["--log_dir", log_dir + f"_{vis}"])
                rates[vis] = len(samples) / (time.perf_counter() - t0)
        finally:
            monitor.UniWriter = real
        check(math.isfinite(s2["mean_fps"]), f"phase 27 {label}: summary {s2}")
    print(f"phase 27 {label}: the whole evaluate_torch.py pass (loading included, no capture on) "
          f"{rates[True]:.2f} pairs/s with the overlays, {rates[False]:.2f} without, on {ctx.card}")
    return rows, os.path.join(log_dir, "prediction.txt")


def bridge_phase(ctx, work: str):
    """Phase 27: the seeded models of phases 4 and 10 through a reference
    file, tools/reference_ckpt_to_torch.py and evaluate_torch.py
    --vis_rate 1. Returns (rows, state for phase 28)."""
    import torch

    from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
    from i2pnet_tpu_torch.models import I2PNet, I2PNetProj, init_random_
    from i2pnet_tpu_torch.train.checkpoint import CheckpointManager

    convert = tool("reference_ckpt_to_torch")
    lr_root = os.path.join(work, "lr_data")
    write_large_range_tree(lr_root, LR_FRAMES)
    cfg = dataclasses.replace(I2PNetConfig(), compute_dtype="bfloat16")
    pcfg = dataclasses.replace(I2PNetProjConfig(), compute_dtype="bfloat16")
    state = {"cmr_root": os.path.join(work, "cmr_data"), "lr_root": lr_root}
    rows = {}
    for proj in (False, True):
        family = "proj" if proj else "free"
        model = init_random_((I2PNetProj(pcfg) if proj else I2PNet(cfg)),
                             torch.Generator().manual_seed(SEED)).eval()
        seeded = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        ref = reference_names(seeded, proj)
        path = os.path.join(work, f"reference_{family}.pth")
        torch.save({"model_state_dict": {"module." + k: v for k, v in ref.items()}, "epoch": 1},
                   path)
        out = os.path.join(work, f"bridged_{family}")
        t0 = time.perf_counter()
        convert.main([path, out] + (["--proj"] if proj else []))
        bridged = CheckpointManager(out).restore_best("model_rotation_best")["model"]
        check(sorted(bridged) == sorted(seeded) and all(torch.equal(bridged[k], seeded[k])
                                                        for k in seeded),
              f"phase 27 {family}: the bridged state_dict differs from the seeded one")
        print(f"phase 27 {family}: {len(ref)} reference tensors ('module.' + RegNet_v2 names in "
              f"'model_state_dict') -> tools/reference_ckpt_to_torch.py -> {len(bridged)} port "
              f"tensors bit-identical to the seeded model's, in {time.perf_counter() - t0:.1f} s")
        if proj:  # the large-range tree is read with numpy: nothing to stand in for
            argv = ["--root_path", lr_root, "--network", "i2pnet_proj"]
            kernels, stand_ins = [ctx.block, ctx.select], contextlib.nullcontext
        else:
            argv = ["--dataset", "kd_cmr_snr", "--network", "i2pnet", "--root_path",
                    state["cmr_root"]]
            kernels, stand_ins = ctx.eval_kernels, (lambda: StandIns("phase 27"))
        argv += ["--model_dir", out, "--compute_dtype", "bfloat16", "--batch_size", str(BATCH)]
        part, pred = vis_evaluation(ctx, f"vis_{family}_evaluate_cli", argv, model, proj, kernels,
                                    stand_ins, work)
        merge_rows(rows, part)
        state[family] = out
        state[f"{family}_pred"] = pred
        del model
    return rows, state


def check_frames(out_dir, samples, out3, heat: bool, label: str) -> None:
    """Every demo PNG decoded with zlib equals its panel re-rendered from the
    frame's sample and logged out3."""
    import numpy as np

    from i2pnet_tpu_torch.eval.visualize import (decalib_extrinsic, render_comparison,
                                                 render_error_heat)

    eye = np.eye(3, 4, dtype=np.float32)
    for i, (s, o) in enumerate(zip(samples, out3)):
        rgb = np.clip(s["rgb"], 0, 255).astype(np.uint8)
        # the demo's own order: the ground truth concatenated, then split
        qt = np.concatenate([s["decalib_real_gt"], s["decalib_dual_gt"]])
        pred, gt = decalib_extrinsic(o[:4], o[4:]), decalib_extrinsic(qt[:4], qt[4:])
        want = render_comparison(rgb, s["lidar"], eye, pred, gt, s["init_intrinsic"])
        if heat:
            want = np.concatenate([want, render_error_heat(rgb, s["lidar"], pred, gt,
                                                           s["init_intrinsic"])], axis=0)
        got = decode_png(os.path.join(out_dir, f"frame_{i:06d}.png"))
        check(got.shape == want.shape and bool((got == want).all()),
              f"{label}: frame {i}'s PNG differs from its panel")


def demo_phase(ctx, work: str, state: dict) -> dict:
    """Phase 28: tools/render_demo_torch.py at B=1 on the bridged models (a
    first frame with its kernel calls held against their plain versions and
    timed, then DEMO_FRAMES frames), every PNG decoded with zlib; then
    tools/render_real_demo_torch.py on a real-rig tree (``real_rig_demo``)."""
    import numpy as np
    import torch

    import evaluate_torch
    from i2pnet_tpu_torch.cli import eval_split
    from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig

    demo = tool("render_demo_torch")
    rows = {}
    per_frame = dict(NO_LAUNCHES, fps=4, encoder_block=15, cv1=1)
    per_proj_frame = PROJ_LAUNCHES
    for proj in (False, True):
        family = "proj" if proj else "free"
        if proj:
            argv = ["--dataset", "kd_corr_nolidar", "--network", "i2pnet_proj", "--root_path",
                    state["lr_root"]]
            kernels, want, cfg = [ctx.block, ctx.select], per_proj_frame, I2PNetProjConfig()
        else:
            argv = ["--dataset", "kd_cmr_snr", "--network", "i2pnet", "--root_path",
                    state["cmr_root"], "--heat"]
            kernels, want, cfg = ctx.eval_kernels, per_frame, I2PNetConfig()
        argv += ["--model_dir", state[family], "--compute_dtype", "bfloat16"]
        out = os.path.join(work, f"demo_{family}")
        label = f"demo_{family}_first_frame"
        t_first = time.perf_counter()
        with StandIns(f"phase 28 {family}"), Captures(kernels) as caps:
            first = ctx.launches_of(label, want, lambda: demo.main(
                argv + ["--out", out + "_first", "--frames", "1"]))
        with torch.no_grad():
            errors = {k["name"]: eval_kernel_error(k["name"], getattr(k["module"], k["plain"]),
                                                   caps[k["name"]].calls) for k in kernels}
        batch_one = [tuple(a[0].shape)[0] for k in kernels for a, _ in caps[k["name"]].calls]
        check(set(batch_one) == {1}, f"phase 28 {family}: batch sizes {set(batch_one)}")
        t_rows = time.perf_counter()
        merge_rows(rows, shape_rows(ctx, label, kernels, caps, ctx.path_launches[label], errors))
        del caps
        t_rows, t_first = time.perf_counter() - t_rows, t_rows - t_first
        with StandIns(f"phase 28 {family} ({DEMO_FRAMES} frames)"):
            t0 = time.perf_counter()
            times = ctx.launches_of(f"demo_{family}", {k: v * DEMO_FRAMES for k, v in want.items()},
                                    lambda: demo.main(argv + ["--out", out, "--frames",
                                                              str(DEMO_FRAMES)]))
            wall = time.perf_counter() - t0
            eargs = evaluate_torch.parse_args([a for a in argv if a != "--heat"])
            ds = eval_split(eargs, dataclasses.replace(cfg, compute_dtype="bfloat16"))
            samples = [ds[i] for i in range(DEMO_FRAMES)]
        check(np.array_equal(first["out3"][0], times["out3"][0]),
              f"phase 28 {family}: the first frame's out3 differs between two runs")
        t_check = time.perf_counter()
        check_frames(out, samples, times["out3"], not proj, f"phase 28 {family}")
        t_check = time.perf_counter() - t_check
        med = {k: statistics.median(times[k]) for k in ("forward_ms", "render_ms", "write_ms")}
        print(f"phase 28 {family} demo: {DEMO_FRAMES} frames at B=1 in {wall:.1f} s, every PNG "
              f"decoded with zlib equal to its panel; median ms a frame: forward "
              f"{med['forward_ms']:.1f} (the first {times['forward_ms'][0]:.1f}), render "
              f"{med['render_ms']:.1f}, PNG write {med['write_ms']:.1f} (zlib) on {ctx.card}")
        print(f"phase 28 {family}: the first-frame run and its checks {t_first:.1f} s, its calls "
              f"timed {t_rows:.1f} s, the PNGs decoded and re-rendered {t_check:.1f} s")

    real_rig_demo(ctx, work, state)
    return rows


def real_rig_demo(ctx, work: str, state: dict) -> None:
    """Phase 28's tools/render_real_demo_torch.py on a real-rig tree, with
    phase 27's free prediction file. The frames are PNGs that
    ``realloc.read_image`` decodes (cv2, else PIL), each held to the array
    written; where neither is installed, .npy frames under .jpg names read
    by ``read_npy_frame``."""
    import importlib.util

    import numpy as np

    from i2pnet_tpu_torch.data import realloc
    from i2pnet_tpu_torch.eval.analysis import parse_prediction_file
    from i2pnet_tpu_torch.eval.visualize import render_comparison, write_png

    readers = {m: importlib.util.find_spec(m) is not None
               for m in ("PIL", "h5py", "cv2", "imageio")}
    decode = readers["cv2"] or readers["PIL"]
    t_tree = time.perf_counter()
    rng = np.random.default_rng(SEED + 28)
    root = os.path.join(work, "real_localize")
    stamps = [f"{1690000000 + i}.{i}" for i in range(REAL_FRAMES)]
    frames = []
    for d in ("velodyne", "images"):
        os.makedirs(os.path.join(root, "sequences", "00", d))
    for ts in stamps:
        pc = street_map(rng, REAL_POINTS)
        np.concatenate([pc.T, rng.uniform(0, 1, (REAL_POINTS, 1))], 1).astype(np.float32).tofile(
            os.path.join(root, "sequences", "00", "velodyne", ts + ".bin"))
        frame = rng.integers(0, 256, size=REAL_FRAME, dtype=np.uint8)
        frames.append(frame)
        images = os.path.join(root, "sequences", "00", "images", ts)
        if decode:
            write_png(images + ".png", frame)
        else:
            with open(images + ".jpg", "wb") as f:
                np.save(f, frame)
    real = tool("render_real_demo_torch")
    t_tree = time.perf_counter() - t_tree
    saved = realloc.read_image
    if not decode:
        realloc.read_image = read_npy_frame
    try:
        t0 = time.perf_counter()
        n = real.main(["--root", root, "--pred", state["free_pred"], "--out",
                       os.path.join(work, "real_demo"), "--frames", str(REAL_FRAMES)])
        wall = time.perf_counter() - t0
        mats = parse_prediction_file(state["free_pred"])
        ds = realloc.RealLocVisDataset(root)
        for i in range(n):
            s = ds[i]
            check(np.array_equal(s["img"], frames[i]),
                  f"phase 28 real demo: frame {i} decoded differs from the array written")
            want = render_comparison(s["img"], s["pcl"].astype(np.float32), mats["init"][i],
                                     mats["pred"][i], mats["gt"][i], s["K"])
            got = decode_png(os.path.join(work, "real_demo", f"{s['seq']}_{s['ts']}.png"))
            check(got.shape == want.shape and bool((got == want).all()),
                  f"phase 28 real demo: frame {i}'s PNG differs from its panel")
    finally:
        realloc.read_image = saved
    check(n == REAL_FRAMES, f"phase 28 real demo: {n} frames")
    how = ("PNGs decoded by realloc.read_image, equal to the arrays written" if decode else
           "realloc.read_image stood in: the frames are .npy under .jpg names")
    print(f"phase 28: importable here {readers}")
    print(f"phase 28 real-rig demo ({how}): {n} frames of {REAL_FRAME[1]}x{REAL_FRAME[0]} "
          f"and {REAL_POINTS} points, {wall * 1e3 / n:.1f} ms a frame (read, render, PNG "
          f"write), every PNG equal to its panel on {ctx.card}; the tree written in "
          f"{t_tree:.1f} s")


def write_raw_odometry(root: str, rng) -> None:
    """A raw KITTI odometry sequence as numpy writes it: velodyne .bin scans
    of a street (RAW_POINTS each), poses.txt (the sensor 1.5 m a frame
    ahead, turning slowly) and calib.txt."""
    import numpy as np

    os.makedirs(os.path.join(root, "velodyne"))
    for i in range(RAW_FRAMES):
        pc = street_map(rng, RAW_POINTS, 2.0, 40.0)
        np.concatenate([pc.T, rng.uniform(0, 1, (RAW_POINTS, 1))], 1).astype(np.float32).tofile(
            os.path.join(root, "velodyne", "%06d.bin" % i))
    rows = []
    for i in range(RAW_FRAMES):
        a = 0.01 * i
        R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
        rows.append(np.hstack([R, [[1.5 * i], [0.05 * i], [0.0]]]).reshape(-1))
    np.savetxt(os.path.join(root, "poses.txt"), np.array(rows))
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write(KITTI_CALIB)


def write_nus_tables(root: str, rng) -> None:
    """A nuScenes v1.0 tree as numpy and json write it: one daytime and one
    night scene of NUS_KEYS key frames with a sweep between each two
    (LIDAR_TOP .pcd.bin, NUS_SWEEP_POINTS points in the local-map box),
    CAM_FRONT frames (NUS_FRAME, ``write_frame`` under .jpg names) and the seven JSON
    tables, the ego yawed and driving ahead."""
    import numpy as np
    from scipy.spatial.transform import Rotation

    def wxyz(rot):
        x, y, z, w = rot.as_quat()
        return [float(w), float(x), float(y), float(z)]

    for d in ("samples/LIDAR_TOP", "sweeps/LIDAR_TOP", "samples/CAM_FRONT", "v1.0-trainval"):
        os.makedirs(os.path.join(root, d))
    yaw = wxyz(Rotation.from_euler("z", 0.2))
    cam_rot = wxyz(Rotation.from_matrix(np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0],
                                                  [0.0, -1.0, 0.0]])))
    t = {name: [] for name in ("scene", "sample", "sample_data", "ego_pose", "calibrated_sensor")}
    t["sensor"] = [{"token": "sen_lidar", "channel": "LIDAR_TOP", "modality": "lidar"},
                   {"token": "sen_cam", "channel": "CAM_FRONT", "modality": "camera"}]
    t["log"] = [{"token": "log0", "logfile": "n008", "vehicle": "n008",
                 "date_captured": "2018-08-01", "location": "boston-seaport"}]
    written = []

    def pose(tok, x, rot=yaw, z=0.0):
        t["ego_pose"].append({"token": f"ep_{tok}", "rotation": rot, "translation": [x, 0.0, z]})

    for name, desc in (("scene-0001", "Parked truck, sunny"), ("scene-0002", "Night drive")):
        chain = []
        for i in range(NUS_KEYS):
            chain.append((f"{name}_L{i}", True, i))
            if i + 1 < NUS_KEYS:
                chain.append((f"{name}_M{i}", False, i + 1))
            t["sample"].append({"token": f"{name}_S{i}", "scene_token": f"scene_{name}",
                                "prev": f"{name}_S{i - 1}" if i else "",
                                "next": f"{name}_S{i + 1}" if i + 1 < NUS_KEYS else ""})
        for j, (tok, key, si) in enumerate(chain):
            pose(tok, 0.25 * j)
            t["calibrated_sensor"].append({"token": f"cs_{tok}", "sensor_token": "sen_lidar",
                                           "translation": [0.0, 0.0, 1.8],
                                           "rotation": [1.0, 0.0, 0.0, 0.0],
                                           "camera_intrinsic": []})
            fn = f"{'samples' if key else 'sweeps'}/LIDAR_TOP/{tok}.pcd.bin"
            if name == "scene-0001":  # the night scene is filtered before any read
                pts = rng.uniform([-12, -7, -2], [12, 17, 3], size=(NUS_SWEEP_POINTS, 3))
                np.concatenate([pts, rng.uniform(0, 1, (NUS_SWEEP_POINTS, 1)),
                                np.zeros((NUS_SWEEP_POINTS, 1))], 1).astype(np.float32).tofile(
                    os.path.join(root, fn))
            t["sample_data"].append({
                "token": tok, "sample_token": f"{name}_S{si}", "ego_pose_token": f"ep_{tok}",
                "calibrated_sensor_token": f"cs_{tok}", "is_key_frame": key, "filename": fn,
                "prev": chain[j - 1][0] if j else "",
                "next": chain[j + 1][0] if j + 1 < len(chain) else ""})
        for i in range(NUS_KEYS):
            tok = f"{name}_CAM_FRONT_{i}"
            pose(tok, 0.5 * i + 0.1)
            t["calibrated_sensor"].append({"token": f"cs_{tok}", "sensor_token": "sen_cam",
                                           "translation": [1.5, 0.0, 1.5], "rotation": cam_rot,
                                           "camera_intrinsic": [list(r) for r in NUS_K]})
            fn = f"samples/CAM_FRONT/{tok}.jpg"
            if name == "scene-0001":
                write_frame(os.path.join(root, fn),
                            rng.integers(0, 256, size=NUS_FRAME, dtype=np.uint8), written)
            t["sample_data"].append({
                "token": tok, "sample_token": f"{name}_S{i}", "ego_pose_token": f"ep_{tok}",
                "calibrated_sensor_token": f"cs_{tok}", "is_key_frame": True, "filename": fn,
                "prev": f"{name}_CAM_FRONT_{i - 1}" if i else "",
                "next": f"{name}_CAM_FRONT_{i + 1}" if i + 1 < NUS_KEYS else ""})
        t["scene"].append({"token": f"scene_{name}", "log_token": "log0", "name": name,
                           "description": desc, "first_sample_token": f"{name}_S0",
                           "nbr_samples": NUS_KEYS})
    for name, records in t.items():
        with open(os.path.join(root, "v1.0-trainval", f"{name}.json"), "w") as f:
            json.dump(records, f)
    check_decoded_frames(written, "phase 29 nuScenes tables")


def npz_local_map(path, pc, intensity) -> None:
    """Stands in for the builders' ``write_local_map`` (h5py): the map's 'PC'
    and 'intensity' as an npz under the map's .h5 name, which
    ``read_npz_map`` reads back."""
    import numpy as np

    with open(path, "wb") as f:
        np.savez(f, PC=pc, intensity=intensity)


def builders_phase(ctx, work: str) -> None:
    """Phase 29: the offline builders on the card's host, from raw files
    numpy writes, with only the h5 writes stood in (``npz_local_map``):
    a KITTI odometry sequence (scans with normals, pose npz, the
    accumulation, the local maps) read by KittiOdometryCMRDataset, and a
    nuScenes split (NuScenesLite over v1.0 JSON tables, generate_split) read
    by NuScenesCMRDataset; one free forward on the card from each."""
    import numpy as np
    import torch

    from i2pnet_tpu_torch.config import I2PNetConfig
    from i2pnet_tpu_torch.data import (KittiOdometryCMRDataset, NuScenesCMRDataset, collate,
                                       prefetch_to_device)
    from i2pnet_tpu_torch.data import preprocess as PP
    from i2pnet_tpu_torch.data import preprocess_nuscenes as PN
    from i2pnet_tpu_torch.data.nuscenes_lite import NuScenesLite
    from i2pnet_tpu_torch.data.pipeline import to_model_batch
    from i2pnet_tpu_torch.models import I2PNet, init_random_

    rng = np.random.default_rng(SEED + 29)
    raw = os.path.join(work, "raw_odometry", "00")
    write_raw_odometry(raw, rng)
    seconds = {}
    t0 = time.perf_counter()
    for i in range(RAW_FRAMES):
        PP.bin_to_npy_with_normals(os.path.join(raw, "velodyne", "%06d.bin" % i),
                                   os.path.join(raw, "snr", "%06d.npy" % i), voxel=0.1)
    seconds["bin_to_npy_with_normals"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    PP.poses_to_npz(os.path.join(raw, "poses.txt"), os.path.join(raw, "poses"))
    seconds["poses_to_npz"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    n = PP.process_sequence_accumulation(os.path.join(raw, "snr"), os.path.join(raw, "poses"),
                                         os.path.join(raw, "calib.txt"),
                                         os.path.join(raw, "snr_acc"), os.path.join(raw, "acc"))
    seconds["process_sequence_accumulation"] = time.perf_counter() - t0
    acc = np.load(os.path.join(raw, "snr_acc", "000005.npy"))
    check(n == RAW_FRAMES and acc.shape[0] == 7 and acc.shape[1] <= 2 * 20480
          and bool(np.isfinite(acc).all()), f"phase 29: accumulation {n}, {acc.shape}")
    seq = os.path.join(work, "built", "kitti_processed_CMRNet", "sequences", "00")
    scans = [np.fromfile(os.path.join(raw, "velodyne", "%06d.bin" % i), np.float32).reshape(-1, 4)
             for i in range(RAW_FRAMES)]
    poses = [PP._load_pose(os.path.join(raw, "poses", "%06d.npz" % i)) for i in range(RAW_FRAMES)]
    saved = PP.write_local_map
    PP.write_local_map = npz_local_map
    try:
        t0 = time.perf_counter()
        PP.build_local_maps(scans, poses, os.path.join(seq, "local_maps"))
        seconds["build_local_maps"] = time.perf_counter() - t0
    finally:
        PP.write_local_map = saved
    os.makedirs(os.path.join(seq, "image_2_npy"))
    for i in range(RAW_FRAMES):
        np.save(os.path.join(seq, "image_2_npy", "%06d.npy" % i),
                rng.integers(0, 256, size=(376, 1241, 3), dtype=np.uint8))
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        f.write(KITTI_CALIB)
    print(f"phase 29 KITTI odometry builders on a raw sequence of {RAW_FRAMES} scans of "
          f"{RAW_POINTS} points (write_local_map stood in: npz under the .h5 names): "
          + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))

    cfg = dataclasses.replace(I2PNetConfig(), compute_dtype="bfloat16")
    model = init_random_(I2PNet(cfg), torch.Generator().manual_seed(SEED)).eval()

    def forward(ds, label):
        batch = to_model_batch(next(prefetch_to_device([collate([ds[i] for i in range(BATCH)])],
                                                       ctx.dev)))
        with torch.no_grad(), Captures(ctx.eval_kernels) as caps:
            out = ctx.launches_of(label, FREE_VAL_LAUNCHES, lambda: model(
                batch["rgb"], batch["lidar"], batch["intrinsic"],
                lidar_feature=batch["lidar_feats"], raw_xyz=batch["raw_xyz"]))
            for k in ctx.eval_kernels:
                eval_kernel_error(k["name"], getattr(k["module"], k["plain"]),
                                  caps[k["name"]].calls)
        check(bool(torch.isfinite(out["out3"]).all()), f"phase 29 {label}: out3 not finite")
        return tuple(batch["rgb"].shape), tuple(batch["lidar"].shape)

    with StandIns("phase 29 (KITTI)"):
        ds = KittiOdometryCMRDataset(os.path.join(work, "built"), mode="test", seed=0)
        check(len(ds) == RAW_FRAMES, f"phase 29: {len(ds)} KITTI samples")
        shapes = forward(ds, "built_kitti_eval")
    print(f"phase 29: KittiOdometryCMRDataset reads the built sequence ({len(ds)} frames); a free "
          f"forward on its first batch {shapes}: finite, every kernel call held against its plain "
          f"version")

    nus_root = os.path.join(work, "nus_raw")
    write_nus_tables(nus_root, rng)
    seconds = {}
    t0 = time.perf_counter()
    nusc = NuScenesLite(nus_root)
    seconds["NuScenesLite"] = time.perf_counter() - t0
    check(nusc.get("sample", "scene-0001_S0")["data"] == {"LIDAR_TOP": "scene-0001_L0",
                                                           "CAM_FRONT": "scene-0001_CAM_FRONT_0"},
          "phase 29: NuScenesLite's reverse index")
    out = os.path.join(work, "nus_built")
    saved = PN.write_local_map
    PN.write_local_map = npz_local_map
    try:
        t0 = time.perf_counter()
        path, entries = PN.generate_split(nusc, out, (0, 10), 1, "test_dataset0.list", seed=0)
        seconds["generate_split"] = time.perf_counter() - t0
    finally:
        PN.write_local_map = saved
    check(entries == NUS_KEYS, f"phase 29: {entries} nuScenes entries")
    print(f"phase 29 nuScenes builders (one daytime scene of {NUS_KEYS} key frames kept, the "
          f"night one filtered; write_local_map stood in): "
          + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))
    with StandIns("phase 29 (nuScenes)", frames=True):
        ds = NuScenesCMRDataset(out, [path], mode="test", seed=0)
        shapes = forward(ds, "built_nus_eval")
    print(f"phase 29: NuScenesCMRDataset reads the built split ({len(ds)} entries); a free forward "
          f"on its first batch {shapes}: finite, every kernel call held against its plain version")


# phase 30: data parallelism. The card's machine holds one H100, so two
# ranks share it under gloo (torch.multiprocessing, spawn), time-sliced: the
# phase checks the DP paths against the single process, and its times are
# no scaling figure; NCCL across cards is not exercised (train_torch.py
# runs under torchrun at W = 1 with NCCL). Each rank writes its launches,
# its kernel-call errors and its tensors to the phase's work dir; a rank
# that raises exits non-zero and the phase raises.
DP_RANKS = 2
DP_EVAL_FRAMES = {7: 14, 8: 13}  # 27 pairs: the last batch 3 rows, 2 + 1 padded on two ranks
DP_FREE_PAIRS = 2 * BATCH + 3
DP_TRAIN_FRAMES = {0: 16, 9: 8}  # phase 18's layout: 2 steps and 1 validation batch an epoch
DP_TIMED_STEPS = 3
# the accumulating DP step (proj): 2 microbatches of the global 8, a rank
# loading its share of each (host_batch_rows: rows 0, 1, 4, 5 and 2, 3, 6,
# 7). Its controls keep each microbatch's rows and change their order: one
# process with the rows interleaved within each microbatch (a reversal of
# 4 rows keeps every pairwise sum, and read 0 on the card), and the ranks
# with their 2 rows of each microbatch swapped
DP_ACCUM = 2
ACCUM_INTERLEAVED = (0, 2, 1, 3, 4, 6, 5, 7)
ACCUM_RANK_SWAPPED = (1, 0, 3, 2)
# the faults planted in the ranks' statistics all-reduce (``planted``); the
# accumulating step adds 'contiguous', each rank's rows as one contiguous
# slice cut into microbatches (the grouping before host_batch_rows)
PLANTED = ("nondiff", "local")
# the gradients' relative L2 gap from the one-process step over the leaves,
# (median, largest): f32 from the f32 step, bf16 from the bf16 step; and
# the bf16 running statistics' gap, relative to the step's update. Set at
# a few times the largest control reading on the card (the block comment
# at dp_phase)
F32_GRAD_BARS = (5e-3, 0.1)
BF16_GRAD_BARS = (0.25, 2.0)
BF16_STAT_BAR = 1e-2
# the accumulating bf16 step's gradient bar: its gap to the one-process f32
# step within these multiples (median, largest) of the one-process bf16
# step's own gap. Against the one-process bf16 step directly (the 0.25 /
# 2.0 above) it reads 0.42 / 0.91 on the card while its controls (the same
# microbatches, their rows in another order) read 6e-3 at most: the split
# over ranks moves the f32 statistics at rounding level, which flips bf16
# roundings and pool taps downstream, and a bf16 step sits 0.52 from the
# f32 gradient in median either way; the faults sit 1.47-2.8x one
# process's gap (the block comment at dp_phase)
BF16_F32_GAP_RATIOS = (1.25, 1.5)
DP_FREE_EVAL_LAUNCHES = dict(NO_LAUNCHES, fps=4 * EVAL_STAGES * 3,
                             encoder_block=15 * EVAL_STAGES * 3, cv1=EVAL_STAGES * 3)
DP_PROJ_EVAL_LAUNCHES = dict(NO_LAUNCHES, **{k: v * EVAL_STAGES * 4
                                             for k, v in PROJ_FORWARD.items()})


def absorbed_biases(model) -> set:
    """The biases that a batch-statistics norm follows (an encoder conv's, a
    normalised Dense's): their true gradient is 0, and a step holds
    cancellation residue there, as tests/test_dp_fused.py excludes them."""
    from i2pnet_tpu_torch.nn.layers import BatchNorm, BatchStatsNorm

    out = set()
    for name, mod in model.named_modules():
        children = dict(mod.named_children())
        for cname, child in children.items():
            if not isinstance(child, (BatchNorm, BatchStatsNorm)):
                continue
            j = cname.rpartition("_")[2]
            for lead in ("Conv", "Dense"):
                if f"{lead}_{j}" in children:
                    out.add(f"{name}.{lead}_{j}.bias".lstrip("."))
    return out


def dp_setup(family: str, dtype: str = "bfloat16", seed: int = SEED, accum: int = 1):
    """A fresh seeded shipped-config model of the family in ``dtype``,
    dropout off, its train state and step (the plain step, or the
    accumulating step over ``accum`` microbatches): (model, cfg, state,
    step)."""
    import torch

    from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
    from i2pnet_tpu_torch.models import I2PNet, I2PNetProj, init_random_
    from i2pnet_tpu_torch.train import (create_train_state, make_accum_train_step,
                                        make_train_step, make_train_step_proj)

    Cfg, Model, make = ((I2PNetProjConfig, I2PNetProj, make_train_step_proj) if family == "proj"
                        else (I2PNetConfig, I2PNet, make_train_step))
    cfg = dataclasses.replace(Cfg(), compute_dtype=dtype, head_dropout_rate=0.0)
    model = init_random_(Model(cfg), torch.Generator().manual_seed(seed))
    state = create_train_state(model, steps_per_epoch=100)
    step = (make_accum_train_step(model, cfg, accum, proj=family == "proj") if accum > 1
            else make(model, cfg))
    return model, cfg, state, step


def dp_batch(family: str, dev) -> dict:
    """Phase 5's (free) or phase 11's (proj) batch of 8: identity ground
    truth."""
    import torch

    from i2pnet_tpu_torch.config import I2PNetConfig

    if family == "proj":
        rgb, lidar, raw, k = make_proj_inputs(dev)
        batch = {"rgb": rgb, "lidar": lidar, "raw_xyz": raw, "intrinsic": k}
    else:
        rgb, lidar, k = make_inputs(I2PNetConfig(), dev)
        batch = {"rgb": rgb, "lidar": lidar, "intrinsic": k}
    batch["decalib_q_gt"] = torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev).repeat(BATCH, 1)
    batch["decalib_t_gt"] = torch.zeros(BATCH, 3, device=dev)
    return batch


def step_tensors(model, metrics, params: bool = True) -> dict:
    """A step's metrics, gradients, parameters (where asked) and
    statistics, on the CPU."""
    out = {"metrics": {k: v.detach().cpu() for k, v in metrics.items()},
           "grads": {k: p.grad.detach().cpu() for k, p in model.named_parameters()},
           "buffers": {k: b.detach().cpu() for k, b in model.named_buffers()}}
    if params:
        out["params"] = {k: p.detach().cpu() for k, p in model.named_parameters()}
    return out


def one_step(family: str, dtype: str, batch: dict, mesh=None, fault=None, accum: int = 1) -> dict:
    """The seeded model's first step on batch (without params), in one
    process, or under mesh as a rank's DP step, with a fault planted where
    asked; over ``accum`` microbatches where asked."""
    import torch

    from i2pnet_tpu_torch.parallel import replicate_, shard_train_step

    model, _, state, step = dp_setup(family, dtype, accum=accum)
    if mesh is not None:
        replicate_(model, mesh)
        step = shard_train_step(step, mesh)
    with planted(fault) if fault else contextlib.nullcontext():
        out = step_tensors(model, step(state, batch), params=False)
    del model, state, step
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def planted(fault: str):
    """A fault planted in the statistics' all-reduce (``parallel/mesh.py``
    ``all_reduce_sum``), to read how far each bar of phase 30 sits from a
    defect: 'nondiff' keeps the forward sum and drops its transpose (what a
    plain ``dist.all_reduce`` gives: no rank's rows get the gradient of the
    other's loss through the statistics), 'local' reduces nothing (each
    rank normalises by its own rows, as a plain DistributedDataParallel
    wrap would)."""
    import torch
    import torch.distributed as dist

    from i2pnet_tpu_torch.parallel import mesh as mesh_module

    class ForwardOnly(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            y = x.contiguous().clone()
            dist.all_reduce(y)
            return y

        @staticmethod
        def backward(ctx, g):
            return g

    real = mesh_module.all_reduce_sum
    mesh_module.all_reduce_sum = {"nondiff": ForwardOnly.apply, "local": torch.clone}[fault]
    try:
        yield
    finally:
        mesh_module.all_reduce_sum = real


def timed_steps(step, state, batch, gen=None) -> float:
    """ms a step: the median of DP_TIMED_STEPS steps, each synchronised."""
    import torch

    times = []
    for _ in range(DP_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def dp_eval_sets(work: str):
    """The fan-out's data: {family: (dataset, the stages' seeds)}: the proj
    family on a large-range test tree of 27 pairs, the free family on 19
    in-memory pairs; both end in a ragged batch of 3."""
    from i2pnet_tpu_torch.config import I2PNetConfig
    from i2pnet_tpu_torch.data import KittiLargeRangeDataset

    return {"proj": KittiLargeRangeDataset(os.path.join(work, "eval_data"), mode="test", seed=0),
            "free": FreeEvalDataset(DP_FREE_PAIRS, I2PNetConfig().lidar_in_points)}


def dp_stages(family: str, dtype: str = "bfloat16"):
    """The 2-stage cascade of phases 16-17: shipped models in ``dtype``
    drawn from SEED + i, in eval mode."""
    import torch

    from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
    from i2pnet_tpu_torch.models import I2PNet, I2PNetProj, init_random_

    Cfg, Model = (I2PNetProjConfig, I2PNetProj) if family == "proj" else (I2PNetConfig, I2PNet)
    cfg = dataclasses.replace(Cfg(), compute_dtype=dtype)
    return [init_random_(Model(cfg), torch.Generator().manual_seed(SEED + i)).eval()
            for i in range(EVAL_STAGES)], cfg


def dp_evaluate(family, ds, log_dir, mesh=None, kernels=(), dtype="bfloat16"):
    """The cascade's Evaluator over ds: (summary, the out3 it scores, the
    kernel captures, the launches) with the calls captured, then, in bf16,
    the pairs/s of a second pass with no capture on (the loading included)
    and its mean_fps."""
    import torch

    from i2pnet_tpu_torch import metrics as M
    from i2pnet_tpu_torch.data import BatchLoader
    from i2pnet_tpu_torch.eval import Evaluator

    models, cfg = dp_stages(family, dtype)
    ev = Evaluator(models, cfg, proj=family == "proj", log_dir=log_dir, mesh=mesh)
    scored, real = [], M.get_extrinsic

    def recording(out3, *a, **k):
        scored.append(out3.copy())
        return real(out3, *a, **k)

    M.get_extrinsic = recording
    try:
        with Captures(kernels) as caps:
            reset_counts()
            summary = ev.validate(BatchLoader(ds, BATCH, shuffle=False, drop_last=False))
            torch.cuda.synchronize()
            launches = read_counts()
    finally:
        M.get_extrinsic = real
    if dtype != "bfloat16":
        return summary, scored, caps, launches, None, None
    t0 = time.perf_counter()
    again = ev.validate(BatchLoader(ds, BATCH, shuffle=False, drop_last=False),
                        save_metrics=False)
    rate = len(ds) / (time.perf_counter() - t0)
    return summary, scored, caps, launches, rate, (again or {}).get("mean_fps")


def dp_rank(rank: int, work: str) -> None:
    """One rank of phase 30 (started by torch.multiprocessing with spawn):
    the proj and free DP steps, the Trainer at W = 2 and the evaluator's
    fan-out, each with its launches counted and every kernel call held
    against its plain version; writes rank{rank}.pt and rank{rank}.json."""
    import torch
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DP_RANKS), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(DP_RANKS))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from i2pnet_tpu_torch.parallel import (host_batch_rows, host_batch_slice, make_mesh,
                                           maybe_initialize_distributed, replicate_,
                                           shard_train_step)

    # two ranks on the one card: gloo, asked for (NCCL refuses them)
    check(maybe_initialize_distributed(backend="gloo", init_method=f"file://{work}/store"),
          "phase 30: no process group")
    mesh = make_mesh()
    eval_kernels, train_kernels, _, _, select, _ = kernel_table()
    report = {"rank": rank, "device": str(mesh.device), "backend": dist.get_backend(),
              "launches": {}, "errors": {}, "ms": {}, "pairs_per_s": {}, "mean_fps": {}}
    tensors = {}
    try:
        rows = host_batch_slice(BATCH)
        for family in ("proj", "free"):
            batch = {k: v[rows] for k, v in dp_batch(family, mesh.device).items()}
            runs = []
            for _ in range(2):  # a second run from the same seeds repeats the first
                model, _, state, step = dp_setup(family)
                replicate_(model, mesh)
                step = shard_train_step(step, mesh)
                kernels = train_kernels + ([eval_kernels[0]] if family == "free" else [])
                with Captures(kernels) as caps:
                    reset_counts()
                    metrics = step(state, batch)
                    torch.cuda.synchronize()
                    launches = read_counts()
                runs.append(step_tensors(model, metrics))
            report["launches"][f"{family}_train"] = launches
            with torch.no_grad():
                errs = {k["name"]: train_kernel_error(
                    k["name"], getattr(k["module"], k["fn"]), getattr(k["module"], k["plain"]),
                    caps[k["name"]].calls) for k in train_kernels}
                if family == "free":
                    errs["fps"] = eval_kernel_error("fps", eval_kernels[0]["module"].fps_plain,
                                                    caps["fps"].calls)
            report["errors"][f"{family}_train"] = errs
            del caps
            same = all(torch.equal(a, runs[1][part][k]) for part in runs[0]
                       for k, a in runs[0][part].items())
            report[f"{family}_repeat_identical"] = same
            tensors[f"{family}_bfloat16"] = runs[0]
            report["ms"][f"{family}_step"] = timed_steps(step, state, batch)
            del model, state, step, runs
            torch.cuda.empty_cache()
            # the same step in f32 (the native chain: no train kernel)
            model, _, state, step = dp_setup(family, "float32")
            replicate_(model, mesh)
            metrics = shard_train_step(step, mesh)(state, batch)
            tensors[f"{family}_float32"] = step_tensors(model, metrics)
            del model, state, step
            torch.cuda.empty_cache()
            # the control (f32, each rank's rows reversed: the DP step's own
            # rounding) and the planted faults in both dtypes; rank 0 keeps them
            runs = {"float32_flipped": ("float32", {k: v.flip(0) for k, v in batch.items()},
                                        None)}
            runs.update({f"{dtype}_{fault}": (dtype, batch, fault) for dtype in
                         ("float32", "bfloat16") for fault in PLANTED})
            for name, (dtype, rows_in, fault) in runs.items():
                out = one_step(family, dtype, rows_in, mesh, fault)
                if rank == 0:
                    tensors[f"{family}_{name}"] = out
            del batch, runs

        # the accumulating proj step: the rank's share of each global
        # microbatch (host_batch_rows), in both dtypes, counted in bf16; rank 0
        # keeps the faults ('contiguous': the rank's contiguous rows) and the
        # control (the rank's 2 rows of each microbatch swapped)
        full = dp_batch("proj", mesh.device)
        grouped = torch.as_tensor(host_batch_rows(BATCH, DP_ACCUM), device=mesh.device)
        batch = {k: v[grouped] for k, v in full.items()}
        contiguous = {k: v[rows] for k, v in full.items()}
        for dtype in ("bfloat16", "float32"):
            reset_counts()
            tensors[f"accum_{dtype}"] = one_step("proj", dtype, batch, mesh, accum=DP_ACCUM)
            torch.cuda.synchronize()
            report["launches"][f"proj_accum_{dtype}"] = read_counts()
            runs = {f"{dtype}_{fault}": (batch, fault) for fault in PLANTED}
            runs[f"{dtype}_contiguous"] = (contiguous, None)
            swap = torch.as_tensor(ACCUM_RANK_SWAPPED, device=mesh.device)
            runs[f"{dtype}_swapped"] = ({k: v[swap] for k, v in batch.items()}, None)
            for name, (rows_in, fault) in runs.items():
                out = one_step("proj", dtype, rows_in, mesh, fault, accum=DP_ACCUM)
                if rank == 0:
                    tensors[f"accum_{name}"] = out
        del full, batch, contiguous, runs
        torch.cuda.empty_cache()

        # the Trainer at W = 2 on phase 18's layout: 2 steps, 1 validation batch
        report["launches"]["trainer"], report["trainer_files"] = dp_trainer(
            os.path.join(work, "trainer_dp"), work)

        # the evaluator's fan-out
        sets = dp_eval_sets(work)
        for family, kernels in (("proj", [eval_kernels[1], select]), ("free", eval_kernels)):
            summary, scored, caps, launches, rate, mean_fps = dp_evaluate(
                family, sets[family], os.path.join(work, f"eval_dp_{family}"), mesh, kernels)
            report["launches"][f"{family}_fan_out"] = launches
            with torch.no_grad():
                report["errors"][f"{family}_fan_out"] = {
                    k["name"]: eval_kernel_error(k["name"], getattr(k["module"], k["plain"]),
                                                 caps[k["name"]].calls) for k in kernels}
            del caps
            report["pairs_per_s"][f"{family}_fan_out"] = rate
            report["mean_fps"][f"{family}_fan_out"] = mean_fps
            tensors[f"{family}_fan_out"] = {"summary": summary, "scored": scored}
        summary, scored = dp_evaluate("proj", sets["proj"], os.path.join(work, "eval_dp_f32"),
                                      mesh, dtype="float32")[:2]
        tensors["proj_fan_out_f32"] = {"summary": summary, "scored": scored}
    finally:
        dist.destroy_process_group()
    torch.save(tensors, os.path.join(work, f"rank{rank}.pt"))
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def dp_trainer(log_dir: str, work: str):
    """The shipped proj config's Trainer (bf16, B=8, one epoch) on the
    phase's training tree: its launches and the files under log_dir."""
    import torch

    import train_torch
    from i2pnet_tpu_torch import cli
    from i2pnet_tpu_torch.train.trainer import Trainer

    args = train_torch.parse_args(["--dataset", "kd_corr_nolidar", "--network", "i2pnet_proj",
                                   "--compute_dtype", "bfloat16",
                                   "--root_path", os.path.join(work, "train_data")])
    model, cfg, _ = cli.build(args)
    train_ds, valid_ds = cli.build_datasets(args, cfg)
    trainer = Trainer(model, cfg, train_ds, valid_ds, log_dir=log_dir, batch_size=BATCH,
                      epochs=1, seed=SEED, proj=True, save_rate=1)
    reset_counts()
    trainer.train()
    torch.cuda.synchronize()
    launches = read_counts()
    trainer.writer.close()
    files = sorted(os.path.relpath(os.path.join(d, f), log_dir).split(".out.tfevents")[0]
                   for d, _, names in os.walk(log_dir) for f in names) \
        if os.path.isdir(log_dir) else []
    return launches, files


def dp_phase(ctx, work: str, path_launches: dict) -> None:
    """Phase 30 (see the block comment above): the single-process
    references, the two ranks, the comparisons, train_torch.py under
    torchrun at W = 1 with NCCL, and the times."""
    import re

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from i2pnet_tpu_torch.eval import SECTION

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    write_large_range_tree(os.path.join(work, "eval_data"), DP_EVAL_FRAMES)
    write_large_range_tree(os.path.join(work, "train_data"), DP_TRAIN_FRAMES, seed=SEED + 1)

    # the single process: each step, its time, the trainer's files, the evaluator
    ref, ms = {}, {}
    for family in ("proj", "free"):
        batch = dp_batch(family, ctx.dev)
        for dtype in ("bfloat16", "float32"):
            model, _, state, step = dp_setup(family, dtype)
            ref[f"{family}_{dtype}_start"] = {k: b.detach().cpu().clone()
                                              for k, b in model.named_buffers()}
            ref[f"{family}_{dtype}"] = step_tensors(model, step(state, batch))
            ref[family] = absorbed_biases(model)
            if dtype == "bfloat16":
                ms[family] = timed_steps(step, state, batch)
            del model, state, step
            torch.cuda.empty_cache()
        # the controls: each step on the batch's rows reversed (the same real
        # numbers, its sums in another order), and in f32 one process at a
        # rank's B=4, twice (rows 0-3, then reversed)
        flip = {k: v.flip(0) for k, v in batch.items()}
        four = {k: v[:BATCH // DP_RANKS] for k, v in batch.items()}
        for name, dtype, rows in (("bfloat16_reversed", "bfloat16", flip),
                                  ("float32_reversed", "float32", flip),
                                  ("float32_b4", "float32", four),
                                  ("float32_b4_reversed", "float32",
                                   {k: v.flip(0) for k, v in four.items()})):
            ref[f"{family}_{name}"] = one_step(family, dtype, rows)
        del batch, flip, four
    # the accumulating proj step over the whole batch, and its control: the
    # rows interleaved within each microbatch (the same microbatches, their
    # sums in another order)
    batch = dp_batch("proj", ctx.dev)
    within = torch.as_tensor(ACCUM_INTERLEAVED, device=ctx.dev)
    for dtype in ("bfloat16", "float32"):
        ref[f"accum_{dtype}"] = one_step("proj", dtype, batch, accum=DP_ACCUM)
        ref[f"accum_{dtype}_interleaved"] = one_step(
            "proj", dtype, {k: v[within] for k, v in batch.items()}, accum=DP_ACCUM)
    del batch
    _, single_files = dp_trainer(os.path.join(work, "trainer_single"), work)
    sets = dp_eval_sets(work)
    single_eval, rates, fps = {}, {}, {}
    for family, kernels in (("proj", [ctx.block, ctx.select]),
                            ("free", [ctx.fps, ctx.block, ctx.cv1])):
        summary, scored, caps, _, rates[family], fps[family] = dp_evaluate(
            family, sets[family], os.path.join(work, f"eval_single_{family}"), kernels=kernels)
        del caps
        single_eval[family] = (summary, scored)
    single_eval["proj_f32"] = dp_evaluate("proj", sets["proj"], os.path.join(
        work, "eval_single_f32"), dtype="float32")[:2]
    torch.cuda.empty_cache()
    print(f"phase 30: the single-process references in {time.perf_counter() - t_phase:.1f} s")

    t0 = time.perf_counter()
    mp.start_processes(dp_rank, args=(work,), nprocs=DP_RANKS, start_method="spawn", join=True)
    print(f"phase 30: {DP_RANKS} ranks (spawn, gloo, one card) in {time.perf_counter() - t0:.1f} s")
    reports = []
    for r in range(DP_RANKS):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(DP_RANKS)]
    check(all(rep["backend"] == "gloo" and rep["device"] == "cuda:0" for rep in reports),
          f"phase 30: ranks on {[(rep['backend'], rep['device']) for rep in reports]}")

    # launches per rank: the single-process path's on the rank's rows
    want = {"proj_train": PROJ_TRAIN_LAUNCHES, "free_train": TRAIN_LAUNCHES,
            "trainer": run_launches(PROJ_TRAIN_LAUNCHES, PROJ_VAL_LAUNCHES, 2, 1),
            "proj_fan_out": DP_PROJ_EVAL_LAUNCHES, "free_fan_out": DP_FREE_EVAL_LAUNCHES}
    for rep in reports:
        for path, counts in want.items():
            check(rep["launches"][path] == counts,
                  f"phase 30 rank {rep['rank']} {path} launches {compact(rep['launches'][path])}")
    for path in want:
        path_launches[f"dp_{path}_per_rank"] = reports[0]["launches"][path]
        print(f"phase 30 launches a rank, {path}: {compact(reports[0]['launches'][path])}")

    # the DP steps against the single process, each reading beside its
    # controls (the same step with its sums in another order) and beside the
    # faults planted in the statistics' all-reduce (``planted``); every bar
    # must hold for the DP step, and every fault must break one of its
    # dtype's bars. Readings: the loss's gap relative to |loss| + 1; the
    # running statistics' largest gap over the buffers, in relative L2 of the
    # step's update (the statistics after it less those before); the
    # gradients' relative L2 gap over the leaves, median and largest (the
    # BN-absorbed biases excluded, as tests/test_dp_fused.py excludes them).
    # f32: the loss within 1e-4 and the statistics within rtol 1e-5 / atol
    # 1e-6 (JAX's DP bars, tests/test_dp_fused.py); the gradients at
    # F32_GRAD_BARS, set from the controls: JAX's 1e-3 of a leaf's max, met
    # at the CPU tests' sizes, does not hold at these, where a reordered sum
    # moves an encoder leaf by up to ~5% of its largest entry. bf16: the loss
    # within JAX's full-step bar (2e-3, tests/test_dp_fused.py:203), the
    # statistics and the gradients against the one-process bf16 step at
    # BF16_STAT_BAR and BF16_GRAD_BARS, set from the controls: each rank
    # rounds its own partial sums, and a bf16 mean may round the other way.
    # Readings on NVIDIA H100 80GB HBM3, 700 W (proj, free): f32 gradients
    # 1.3e-3 / 3.8e-2 and 2.4e-3 / 2.3e-2, the largest control 2.1e-3 /
    # 2.5e-2, 'nondiff' 0.54 and 0.62 in median; bf16 gradients 0.15 / 1.1
    # and 0.14 / 0.92, controls up to 0.13 / 1.0, the faults 0.38-1.1 in
    # median; bf16 statistics 4.4e-3 and 5.0e-3, controls up to 2.0e-3,
    # 'local' 0.12 and 0.058. The accumulating proj step (2 microbatches, 2
    # rows of each a rank) takes the same bars, but for its bf16 gradients:
    # against one process they read 0.42 / 0.91 while its controls read
    # 3.5e-3 / 4.3e-2 (one process, rows interleaved) and 5.7e-3 / 4.9e-2
    # (the ranks' rows swapped), so its bar is the gap to the one-process
    # f32 step, within BF16_F32_GAP_RATIOS of the one-process bf16 step's
    # (0.525 / 1.53): DP 0.543 / 1.48, the faults 0.774 ('nondiff'), 1.49
    # ('local') and 1.30 ('contiguous') in median; f32 gradients 6.4e-4 /
    # 3.5e-2, controls up to 7.1e-4 / 1.4e-2, the faults 0.58-1.41.
    def leaf_gaps(got, want, skip):
        return {k: float((got[k] - w).norm()) / (float(w.norm()) + 1e-12)
                for k, w in want.items() if k not in skip}

    def loss_gap(got, want):
        a, b = float(got["metrics"]["loss"]), float(want["metrics"]["loss"])
        return abs(a - b) / (abs(b) + 1)

    def stat_gap(got, want, start):
        return max(float((got[k] - w).norm()) / float((w - start[k]).norm())
                   for k, w in want.items() if float((w - start[k]).norm()) > 0)

    def grad_gap(got, want, skip):
        gaps = leaf_gaps(got["grads"], want["grads"], skip)
        return statistics.median(gaps.values()), max(gaps.values())

    def fmt(pair):
        return f"{pair[0]:.3e} / {pair[1]:.3e}"

    def hold(label, dtype, single, dp, start, controls, faults, skip, f32=None,
             anchored=False):
        """Every bar of dtype for the DP step dp against the one-process
        step single, beside the controls' readings; each fault must break
        one. With f32 (the one-process f32 step), each bf16 run's gradient
        gap to it is printed too; ``anchored`` makes that gap the gradient
        bar: dp's within BF16_F32_GAP_RATIOS of single's."""
        loss_bar, grad_bars = ((1e-4, F32_GRAD_BARS) if dtype == "float32"
                               else (2e-3, BF16_GRAD_BARS))
        if anchored:
            own = grad_gap(single, f32, skip)
            grad_bars = tuple(r * g for r, g in zip(BF16_F32_GAP_RATIOS, own))

        def bars_broken(got):
            med, top = grad_gap(got, f32 if anchored else single, skip)
            out = []
            if loss_gap(got, single) > loss_bar:
                out.append("loss")
            if dtype == "float32":
                if not all(torch.allclose(got["buffers"][k], b, rtol=1e-5, atol=1e-6)
                           for k, b in single["buffers"].items()):
                    out.append("statistics")
            elif stat_gap(got["buffers"], single["buffers"], start) > BF16_STAT_BAR:
                out.append("statistics")
            if med > grad_bars[0] or top > grad_bars[1]:
                out.append("gradients")
            return out

        broken = bars_broken(dp)
        gaps = leaf_gaps(dp["grads"], single["grads"], skip)
        bars = (f"against the f32 step {fmt(grad_gap(dp, f32, skip))}, bars "
                f"{fmt(grad_bars)}: {BF16_F32_GAP_RATIOS} x one process's {fmt(own)}; "
                if anchored else f"bars {fmt(grad_bars)}; ")
        print(f"{label} step on {DP_RANKS} ranks (B={BATCH // DP_RANKS} a rank) against one "
              f"process: loss {float(dp['metrics']['loss']):.6f} / "
              f"{float(single['metrics']['loss']):.6f}, gap {loss_gap(dp, single):.3e} (bar "
              f"{loss_bar:g}); statistics {stat_gap(dp['buffers'], single['buffers'], start):.3e}"
              f"{'' if dtype == 'float32' else f' (bar {BF16_STAT_BAR:g})'}; gradients over "
              f"{len(gaps)} leaves (the {len(skip)} absorbed biases excluded), median / largest "
              f"{fmt(grad_gap(dp, single, skip))} ({bars}the largest at "
              f"{max(gaps, key=gaps.get)})")
        for name, (a, b) in controls.items():
            print(f"{label} control, {name}: loss {loss_gap(b, a):.3e}; statistics "
                  f"{stat_gap(b['buffers'], a['buffers'], start):.3e}; gradients "
                  f"{fmt(grad_gap(b, a, skip))}")
        for fault, got in faults.items():
            hit = bars_broken(got)
            print(f"{label} planted '{fault}': loss {loss_gap(got, single):.3e}; statistics "
                  f"{stat_gap(got['buffers'], single['buffers'], start):.3e}; gradients "
                  f"{fmt(grad_gap(got, single, skip))}; breaks {hit}")
            check(hit, f"{label}: the planted '{fault}' fault breaks no bar")
        if f32 is not None:
            runs = {"one process": single, "DP": dp, **{f"control '{n}'": b for n, (_, b) in
                                                       controls.items()}, **faults}
            print(f"{label}, gradients against the f32 step: " + "; ".join(
                f"{n} {fmt(grad_gap(g, f32, skip))}" for n, g in runs.items()))
        check(not broken, f"{label}: the DP step breaks the bars of {broken}")

    for family in ("proj", "free"):
        skip, r0 = ref[family], ranks[0]
        for dtype in ("float32", "bfloat16"):
            single, dp = ref[f"{family}_{dtype}"], r0[f"{family}_{dtype}"]
            controls = {"one process, rows reversed": (single, ref[f"{family}_{dtype}_reversed"])}
            if dtype == "float32":
                controls["one process at B=4, rows reversed"] = (
                    ref[f"{family}_float32_b4"], ref[f"{family}_float32_b4_reversed"])
                controls[f"{DP_RANKS} ranks, each rank's rows reversed"] = (
                    dp, r0[f"{family}_float32_flipped"])
            hold(f"phase 30 {family} {dtype}", dtype, single, dp,
                 ref[f"{family}_{dtype}_start"], controls,
                 {f: r0[f"{family}_{dtype}_{f}"] for f in PLANTED}, skip,
                 f32=ref[f"{family}_float32"] if dtype == "bfloat16" else None)
        for part in ("params", "buffers", "grads"):
            for dtype in ("bfloat16", "float32"):
                a, b = ranks[0][f"{family}_{dtype}"][part], ranks[1][f"{family}_{dtype}"][part]
                check(all(torch.equal(v, b[k]) for k, v in a.items()),
                      f"phase 30 {family} {dtype}: the ranks' {part} differ after the step")
        check(all(rep[f"{family}_repeat_identical"] for rep in reports),
              f"phase 30 {family}: a second 2-rank run differs from the first")
        errs = {k: max(rep["errors"][f"{family}_train"][k] for rep in reports)
                for k in reports[0]["errors"][f"{family}_train"]}
        print(f"phase 30 {family}: the ranks' parameters, statistics and gradients "
              f"bit-identical (bf16 and f32); a second bf16 run bit-identical; kernel calls "
              f"against their plain versions, worst errors {errs}")

    # the accumulating proj step: each rank's share of each global microbatch
    for rep in reports:
        for dtype in ("bfloat16", "float32"):
            got = rep["launches"][f"proj_accum_{dtype}"]
            want = (dict(NO_LAUNCHES) if dtype == "float32"
                    else {k: DP_ACCUM * v for k, v in PROJ_TRAIN_LAUNCHES.items()})
            check(got == want, f"phase 30 rank {rep['rank']} accumulating {dtype} step launches "
                               f"{compact(got)}")
    path_launches["dp_proj_accum_per_rank"] = reports[0]["launches"]["proj_accum_bfloat16"]
    print(f"phase 30 launches a rank, the accumulating proj step (bf16, {DP_ACCUM} microbatches):"
          f" {compact(reports[0]['launches']['proj_accum_bfloat16'])}")
    r0 = ranks[0]
    for dtype in ("float32", "bfloat16"):
        single, dp = ref[f"accum_{dtype}"], r0[f"accum_{dtype}"]
        controls = {"one process, rows interleaved within each microbatch": (
            single, ref[f"accum_{dtype}_interleaved"]),
            f"{DP_RANKS} ranks, each rank's rows of a microbatch swapped": (
            dp, r0[f"accum_{dtype}_swapped"])}
        hold(f"phase 30 proj {dtype} accum_steps={DP_ACCUM}", dtype, single, dp,
             ref[f"proj_{dtype}_start"], controls,
             {f: r0[f"accum_{dtype}_{f}"] for f in PLANTED + ("contiguous",)}, ref["proj"],
             f32=ref["accum_float32"] if dtype == "bfloat16" else None,
             anchored=dtype == "bfloat16")
        for part in ("buffers", "grads"):
            a, b = ranks[0][f"accum_{dtype}"][part], ranks[1][f"accum_{dtype}"][part]
            check(all(torch.equal(v, b[k]) for k, v in a.items()),
                  f"phase 30 accumulating {dtype} step: the ranks' {part} differ")
    print(f"phase 30 accumulating proj step ({DP_ACCUM} microbatches, each rank its share of "
          f"each): the ranks' statistics and gradients bit-identical (bf16 and f32)")

    # the Trainer at W = 2: rank 0's files alone, the single process's set
    check(reports[0]["trainer_files"] == reports[1]["trainer_files"] == single_files,
          f"phase 30 Trainer: files {reports[0]['trainer_files']} against {single_files}")
    print(f"phase 30: the Trainer on {DP_RANKS} ranks, 2 steps and 1 validation batch: "
          f"{len(single_files)} files, the single process's names, written by rank 0")

    # the fan-out against the single-process evaluator
    for family in ("proj", "free"):
        lead, other = ranks[0][f"{family}_fan_out"], ranks[1][f"{family}_fan_out"]
        summary, scored = single_eval[family]
        check(other["summary"] is None and not other["scored"],
              f"phase 30 {family} fan-out: rank 1 scored")
        check([a.shape for a in lead["scored"]] == [a.shape for a in scored]
              and lead["summary"]["count"] == summary["count"] == len(sets[family]),
              f"phase 30 {family} fan-out: {[a.shape for a in lead['scored']]}")
        gap = max(float(abs(a - b).max()) for a, b in zip(lead["scored"], scored))
        # free: nothing batch-wide at eval, so bit for bit. proj: the
        # statistics sum in another order; in f32 within the CPU test's
        # 1e-4, and in bf16, where a bf16 mean may round the other way, no
        # further from the f32 cascade than the one-process bf16 cascade
        if family == "free":
            check(gap == 0.0, f"phase 30 free fan-out: out3 {gap} from the single process")
        else:
            f32 = np.concatenate(single_eval["proj_f32"][1])
            gap32 = float(abs(np.concatenate(ranks[0]["proj_fan_out_f32"]["scored"]) - f32).max())
            check(gap32 <= 1e-4, f"phase 30 proj f32 fan-out: out3 {gap32} from the single process")
            one = float(abs(np.concatenate(scored) - f32).max())
            dp = float(abs(np.concatenate(lead["scored"]) - f32).max())
            check(dp <= 1.5 * one + 1e-4, f"phase 30 proj bf16 fan-out: out3 {dp} from the f32 "
                                          f"cascade, one process {one}")
            print(f"phase 30 proj fan-out: in f32 out3 within {gap32:.3e} of the single process; "
                  f"in bf16 within {gap:.3e}, and {dp:.3e} from the f32 cascade against the "
                  f"single process's {one:.3e}")
        preds = []
        for d in (f"eval_dp_{family}", f"eval_single_{family}"):
            with open(os.path.join(work, d, "prediction.txt")) as f:
                preds.append([line for line in f if line.startswith(SECTION)])
        check(preds[0] == preds[1] and len(preds[0]) == len(sets[family]),
              f"phase 30 {family} fan-out: prediction.txt sections")
        # rank 0 alone wrote: one metrics npz, a log line a pass (two passes)
        for d in (f"eval_dp_{family}", f"eval_single_{family}"):
            names = os.listdir(os.path.join(work, d))
            with open(os.path.join(work, d, "log_test.txt")) as f:
                lines = f.read().splitlines()
            check(len(lines) == 2 and sum(n.startswith("metrics_") for n in names) == 1,
                  f"phase 30 {family}: {d} holds {sorted(names)}, {len(lines)} log lines")
        print(f"phase 30 {family} fan-out on {DP_RANKS} ranks: out3 of {len(sets[family])} pairs "
              f"(a ragged last batch) {'bit-identical to' if gap == 0 else f'within {gap:.3e} of'}"
              f" the single-process Evaluator; prediction.txt's {len(preds[0])} sections in its "
              f"order")

    # train_torch.py under torchrun at W = 1: the CLI's init (NCCL) and rank 0's writes
    log_dir = os.path.join(work, "torchrun_run")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
         os.path.join(here, "train_torch.py"), "--dataset", "kd_corr_nolidar", "--network",
         "i2pnet_proj", "--compute_dtype", "bfloat16", "--batch_size", str(BATCH),
         "--root_path", os.path.join(work, "train_data"), "--log_dir", log_dir,
         "--max_epoch", "1"],
        capture_output=True, text=True, timeout=600, cwd=here,
        env=dict(os.environ, NCCL_DEBUG="INFO"))
    wall = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    check(proc.returncode == 0, f"phase 30 torchrun train_torch.py: exit {proc.returncode}\n"
                                f"{out[-4000:]}")
    check(re.search(r"NCCL INFO", out) is not None, "phase 30 torchrun: no NCCL communicator")
    names = set(os.listdir(log_dir))
    check({"config.json", "metrics.jsonl", "log.txt", "torch"} <= names
          and os.listdir(os.path.join(log_dir, "torch", "ckpt")) == ["0.pt"],
          f"phase 30 torchrun: files {sorted(names)}")
    print(f"phase 30: torchrun --nproc_per_node 1 train_torch.py (NCCL, W = 1): one epoch of 2 "
          f"steps and 1 validation batch in {wall:.1f} s with the start-up; rank 0's files and "
          f"checkpoint written")

    # evaluate_torch.py --dp under torchrun at W = 1 (NCCL) on that run's
    # checkpoint, over the fan-out's 27 pairs (f32, the CLI's default),
    # against evaluate_torch.py in a plain process (the same defaults: TF32
    # on in cuDNN, which this process turns off)
    from i2pnet_tpu_torch.eval import analysis

    eval_argv = [os.path.join(here, "evaluate_torch.py"), "--dataset", "kd_corr_nolidar",
                 "--network", "i2pnet_proj", "--root_path", os.path.join(work, "eval_data"),
                 "--model_dir", log_dir, "--batch_size", str(BATCH), "--log_dir"]
    dirs = [os.path.join(work, d) for d in ("torchrun_eval", "single_eval")]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
         *eval_argv, dirs[0], "--dp"], capture_output=True, text=True, timeout=600, cwd=here,
        env=dict(os.environ, NCCL_DEBUG="INFO"))
    wall = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    check(proc.returncode == 0, f"phase 30 torchrun evaluate_torch.py --dp: exit "
                                f"{proc.returncode}\n{out[-4000:]}")
    check(re.search(r"NCCL INFO", out) is not None,
          "phase 30 torchrun evaluate_torch.py: no NCCL communicator")
    proc = subprocess.run([sys.executable, *eval_argv, dirs[1]], capture_output=True, text=True,
                          timeout=600, cwd=here)
    check(proc.returncode == 0, f"phase 30 evaluate_torch.py: exit {proc.returncode}\n"
                                f"{(proc.stdout + proc.stderr)[-4000:]}")
    count = int(re.search(r"count: (\d+)", proc.stdout).group(1))
    preds = [analysis.parse_prediction_file(os.path.join(d, "prediction.txt")) for d in dirs]
    sections = []
    for d in dirs:
        with open(os.path.join(d, "prediction.txt")) as f:
            sections.append([line for line in f if line.startswith(SECTION)])
    names = [sorted(n.split("_")[0] if n.startswith("metrics_") else n for n in os.listdir(d))
             for d in dirs]
    gap = float(np.abs(preds[0]["pred"] - preds[1]["pred"]).max())
    check(names[0] == names[1] and sections[0] == sections[1]
          and len(sections[0]) == count == len(sets["proj"]),
          f"phase 30 torchrun evaluate_torch.py --dp: files {names}, "
          f"{len(sections[0])} sections against {len(sections[1])}")
    check(np.array_equal(preds[0]["init"], preds[1]["init"])
          and np.array_equal(preds[0]["gt"], preds[1]["gt"]) and gap <= 1e-4,
          f"phase 30 torchrun evaluate_torch.py --dp: predictions {gap} from one process")
    print(f"phase 30: torchrun --nproc_per_node 1 evaluate_torch.py --dp (NCCL, W = 1): "
          f"{count} pairs in {wall:.1f} s with the start-up; the files and prediction.txt's "
          f"sections of evaluate_torch.py in a plain process, the predictions within {gap:.3e}")

    print(f"phase 30 times: {DP_RANKS} ranks time-sliced on one card, not a scaling figure; "
          f"NCCL across cards is not exercised")
    for family in ("proj", "free"):
        dp_ms = max(rep["ms"][f"{family}_step"] for rep in reports)
        print(f"phase 30 {family} train step at B={BATCH}: {ms[family]:.3f} ms in one process, "
              f"{dp_ms:.3f} ms on {DP_RANKS} ranks time-sliced on one card (B={BATCH // DP_RANKS} "
              f"a rank; the slower rank's median of {DP_TIMED_STEPS}) on {ctx.card}")
        dp_rate = reports[0]["pairs_per_s"][f"{family}_fan_out"]
        print(f"phase 30 {family} evaluator, {EVAL_STAGES}-stage cascade: {rates[family]:.2f} "
              f"pairs/s in one process (mean_fps {fps[family]:.2f}), {dp_rate:.2f} pairs/s on "
              f"{DP_RANKS} ranks time-sliced on one card (mean_fps "
              f"{reports[0]['mean_fps'][f'{family}_fan_out']:.2f}), the loading included, on "
              f"{ctx.card}")
    print(f"phase 30: {time.perf_counter() - t_phase:.1f} s")


# phase 31 exports the shipped configs' bf16 eval forwards through
# tools/export_model_torch.py (free at B=8 and B=1, proj at B=8) and serves
# each program in a fresh python3 that imports torch and the op library
# alone (``serve_exported``); phase 32 runs tools/protocol_rehearsal_torch.py
# on its proj family at a reduced size
EXPORT_CASES = (("free", BATCH), ("free", 1), ("proj", BATCH))
EXPORT_LAUNCHES = {"free": dict(NO_LAUNCHES, fps=4, encoder_block=15, cv1=1),
                   "proj": PROJ_LAUNCHES}
REHEARSAL_ARGS = ("--families", "proj", "--frames", "20", "--max_epoch", "1")
REHEARSAL_PAIRS = 8  # max(4, 20 // 10) frames of each test sequence, 7 and 8


def serve_exported(cases_path: str) -> None:
    """Phase 31's serving host, in a fresh python3: imports torch and the op
    library alone, loads each program of cases_path, runs it once on its
    inputs with the eval kernels' calls captured and counted, holds every
    call against its plain version (phase 3's bars), and times it (median
    of WINDOWS windows of ITERS calls, and replayed as a CUDA graph); saves
    each case's outputs and readings to its ``result`` file."""
    import torch

    import i2pnet_tpu_torch.ops.library  # noqa: F401  (registers torch.ops.i2pnet.*)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    eval_kernels, select, dense = eval_kernel_table()
    kernels = eval_kernels + [select, dense]
    counted = _counted_modules()
    with open(cases_path) as f:
        cases = json.load(f)
    for case in cases:
        t0 = time.perf_counter()
        fn = torch.export.load(case["program"]).module()
        load_s = time.perf_counter() - t0
        args = torch.load(case["inputs"])
        with torch.no_grad():
            with Captures(kernels) as caps:
                for mod in counted.values():
                    mod.launches = 0
                out = fn(*args)
                torch.cuda.synchronize()
                launches = dict(NO_LAUNCHES, **{k: m.launches for k, m in counted.items()})
            print(f"phase 31 served {case['label']}:")
            errors = {k["name"]: eval_kernel_error(k["name"], getattr(k["module"], k["plain"]),
                                                   caps[k["name"]].calls)
                      for k in kernels if caps[k["name"]].calls}
            del caps
            ms, spread = windows_ms(lambda: fn(*args))
            graph_ms = cuda_ms(graph_of(lambda: fn(*args)).replay, ITERS)
        torch.save({"out": {k: v.cpu() for k, v in out.items()}, "launches": launches,
                    "errors": errors, "ms": ms, "spread": spread, "graph_ms": graph_ms,
                    "load_s": load_s,
                    "modules": sorted(m for m in sys.modules if m.startswith("i2pnet_tpu_torch"))},
                   case["result"])
        del fn, args, out
        torch.cuda.empty_cache()


def export_phase(ctx, work: str, path_launches: dict) -> None:
    """Phase 31: each of EXPORT_CASES exported, timed eagerly and replayed
    in this process, then served from its file in a fresh python3
    (``serve_exported``): its outputs bit-identical to the eager forward's,
    its launches those of the eager forward (EXPORT_LAUNCHES), every kernel
    call within its bar, and no model code imported there."""
    import torch

    from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
    from i2pnet_tpu_torch.models import I2PNet, I2PNetProj, init_random_

    X = tool("export_model_torch")
    cases, eager = [], {}
    for family, B in EXPORT_CASES:
        proj = family == "proj"
        Cfg, Model = (I2PNetProjConfig, I2PNetProj) if proj else (I2PNetConfig, I2PNet)
        cfg = dataclasses.replace(Cfg(), compute_dtype="bfloat16")
        model = init_random_(Model(cfg), torch.Generator().manual_seed(SEED)).eval()
        t0 = time.perf_counter()
        blob = X.export_model(model, cfg, proj, B)
        export_s = time.perf_counter() - t0
        label = f"{family}_b{B}"
        case = {"label": label, "family": family,
                **{k: os.path.join(work, f"{label}.{ext}") for k, ext in
                   (("program", "pt2"), ("inputs", "inputs.pt"), ("result", "result.pt"))}}
        with open(case["program"], "wb") as f:
            f.write(blob)
        inputs = make_proj_inputs(ctx.dev) if proj else make_inputs(cfg, ctx.dev)
        inputs = tuple(a[:B].contiguous() for a in inputs)
        torch.save(inputs, case["inputs"])
        with torch.no_grad():
            reset_counts()
            out3 = model(*inputs)["out3"]
            torch.cuda.synchronize()
            launches = read_counts()
            check(launches == EXPORT_LAUNCHES[family],
                  f"phase 31 {label}: eager launches {compact(launches)}")
            ms, spread = windows_ms(lambda: model(*inputs))
            graph_ms = cuda_ms(graph_of(lambda: model(*inputs)).replay, ITERS)
        eager[label] = dict(out3=out3.cpu(), ms=ms, spread=spread, graph_ms=graph_ms,
                            export_s=export_s, mb=len(blob) / 1e6)
        cases.append(case)
        del model, inputs, out3, blob
        torch.cuda.empty_cache()
    cases_path = os.path.join(work, "cases.json")
    with open(cases_path, "w") as f:
        json.dump(cases, f)
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {here!r}); import chip_smoke; "
                               f"chip_smoke.serve_exported({cases_path!r})"],
        capture_output=True, text=True, timeout=600, cwd=here)
    serve_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"phase 31 serving process: exit {proc.returncode}\n"
                                f"{(proc.stdout + proc.stderr)[-4000:]}")
    print(proc.stdout.rstrip())
    for case in cases:
        label, e = case["label"], eager[case["label"]]
        r = torch.load(case["result"], weights_only=False)
        got = r["out"]
        check(torch.equal(got["q"], e["out3"][:, :4]) and torch.equal(got["t"], e["out3"][:, 4:]),
              f"phase 31 {label}: the served program's q/t differ from the eager forward's")
        check(r["launches"] == EXPORT_LAUNCHES[case["family"]],
              f"phase 31 {label}: served launches {compact(r['launches'])}")
        model_code = [m for m in r["modules"] if not m.startswith("i2pnet_tpu_torch.ops")
                      and m != "i2pnet_tpu_torch"]
        check(not model_code, f"phase 31: the serving process imported {model_code}")
        path_launches[f"export_{label}"] = r["launches"]
        B = e["out3"].shape[0]
        print(f"phase 31 {label}: exported in {e['export_s']:.1f} s ({e['mb']:.1f} MB), loaded in "
              f"{r['load_s']:.1f} s in the serving process; q/t bit-identical to the eager "
              f"forward; launches {compact(r['launches'])}; worst kernel errors {r['errors']}")
        print(f"phase 31 {label} forward at B={B}: served {r['ms']:.3f} ms (spread "
              f"{r['spread']:.1f}%), served and graph-replayed {r['graph_ms']:.3f} ms; eager "
              f"{e['ms']:.3f} ms (spread {e['spread']:.1f}%), eager graph-replayed "
              f"{e['graph_ms']:.3f} ms, on {ctx.card}")
    print(f"phase 31: the serving process in {serve_s:.1f} s, imports {r['modules']}")


def rehearsal_phase(ctx, work: str) -> None:
    """Phase 32: tools/protocol_rehearsal_torch.py's proj family at a reduced
    size (REHEARSAL_ARGS): its JSON lines, the trainer's and the
    evaluation's files, finite metrics over the test split's pairs."""
    import numpy as np

    from i2pnet_tpu_torch.eval import SECTION

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(work, "rehearsal")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "tools", "protocol_rehearsal_torch.py"), "--workdir",
         root, *REHEARSAL_ARGS], capture_output=True, text=True, timeout=900, cwd=here)
    wall = time.perf_counter() - t0
    log = os.path.join(root, "proj", "run.log")
    tail = open(log).read()[-3000:] if os.path.exists(log) else ""
    check(proc.returncode == 0, f"phase 32 protocol_rehearsal_torch.py: exit {proc.returncode}\n"
                                f"{(proc.stdout + proc.stderr)[-3000:]}\n{tail}")
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    check([(d["family"], d["stage"]) for d in lines]
          == [("proj", s) for s in ("generated", "trained", "evaluated", "protocol")],
          f"phase 32: stages {lines}")
    evaluated, protocol = lines[2], lines[3]
    check(evaluated["n_eval"] == protocol["n_eval"] == REHEARSAL_PAIRS
          and all(math.isfinite(v) for k, v in evaluated.items() if k.startswith("mean_")),
          f"phase 32: summary {evaluated}")
    check(all(math.isfinite(v) for part in ("model", "identity") for v in protocol[part].values()),
          f"phase 32: protocol {protocol}")
    log_dir, info = os.path.join(root, "proj", "log"), os.path.join(root, "proj", "info_test")
    names = set(os.listdir(log_dir))
    ckpts = os.listdir(os.path.join(log_dir, "torch", "ckpt"))
    check({"config.json", "metrics.jsonl", "log.txt", "torch"} <= names and ckpts,
          f"phase 32: the trainer's files {sorted(names)}, checkpoints {ckpts}")
    infos = os.listdir(info)
    with open(os.path.join(info, "prediction.txt")) as f:
        sections = sum(line.startswith(SECTION) for line in f)
    check("prediction.txt" in infos and any(n.startswith("metrics_") for n in infos)
          and sections == REHEARSAL_PAIRS, f"phase 32: evaluation files {sorted(infos)}, "
                                           f"{sections} sections")
    npz = np.load(os.path.join(info, sorted(n for n in infos if n.endswith(".npz"))[-1]))
    check(len(npz["RRE"]) == REHEARSAL_PAIRS, f"phase 32: metrics npz {npz.files}")
    print(f"phase 32: protocol_rehearsal_torch.py {' '.join(REHEARSAL_ARGS)}: "
          f"{json.dumps(evaluated)}")
    print(f"phase 32: {json.dumps(protocol)}")
    print(f"phase 32: train_torch.py -> {len(ckpts)} checkpoints -> evaluate_torch.py --analyze "
          f"-> prediction.txt ({sections} pairs) in {wall:.1f} s on {ctx.card}")


# phase 33: the JAX package's code that no model path runs, at full width.
# The dist_mode level at the shipped lidar_lv1 geometry launches the select
# kernel once a forward on its dense eval route; the dense and gathered f32
# routes meet at the dense tests' bar (tests/test_dense_window.py). The
# card's f32 ResNet-34 and upconv against the CPU's with TF32 off, at
# CARD_CPU_BAR: the sound readings lie at 3e-7-4e-6 of max(|ref|, 1), and
# the same comparison with TF32 on (``tf32_on``, the control, read in every
# run) must land above the bar, so a run where TF32 is silently on fails.
# The card's f32 gradients against the CPU's at GRAD_BAR of the module's
# largest gradient, the CPU tests' bar against JAX
# (tests/test_torch_dist_mode.py). bf16 against f32 on the card at a bar
# that catches a wrong layout or stride (O(1)).
DIST_LAUNCHES = dict(NO_LAUNCHES, select=1, dense_level=7)
DIST_LEVEL = dict(out_h=16, out_w=225, stride_h=4, stride_w=8, kernel_size=(9, 15), nsample=32,
                  distance=0.75, mlp=(16, 16, 32))
DIST_UPCONV = dict(out_h=4, out_w=57, stride_h=1, stride_w=2, kernel_size=(5, 9), nsample=8,
                   distance=9.0, mlp=(128, 64), mlp2=(64,))
DENSE_BAR = 1e-5
CARD_CPU_BAR = 1e-4
GRAD_BAR = 1e-3
BF16_BAR = 0.1
TRAIN_ITERS = 5


@contextlib.contextmanager
def tf32_on():
    """TF32 on for convolutions and matmuls (the control of the card
    against the CPU); off again after."""
    import torch

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def proj_range_images(dev):
    """Phase 10's proj inputs projected as ``I2PNetProj`` projects them:
    (the shipped config, raw grid, warped grid, feature grid), 64x1800."""
    import torch

    from i2pnet_tpu_torch.config import I2PNetProjConfig
    from i2pnet_tpu_torch.models.i2pnet_proj import FEATURE_WIDTH
    from i2pnet_tpu_torch.ops.projection import spherical_project

    cfg = I2PNetProjConfig()
    _, lidar, raw, _ = make_proj_inputs(dev)
    feats0 = torch.zeros(BATCH, raw.shape[1], FEATURE_WIDTH, device=dev)
    raw_grid, (norm_grid, xyz_grid) = spherical_project(
        raw, [feats0, lidar], cfg.init_H, cfg.init_W, cfg.fup, cfg.fdown, use_rank=cfg.rank,
        ref_pad_quirk=cfg.ref_pad_quirk)
    return cfg, raw_grid, xyz_grid, norm_grid


def true_zero_leaves(module) -> set:
    """The Dense biases that feed a batch-statistics normalisation: the
    normalisation subtracts the batch mean, so their true gradient is 0 and
    a reading is rounding noise."""
    return {f"{name}.Dense_0.bias" for name, m in module.named_modules()
            if getattr(m, "Dense_0", None) is not None and getattr(m, "Dense_0").bias is not None
            and (getattr(m, "BatchStatsNorm_0", None) is not None
                 or getattr(m, "BatchNorm_0", None) is not None)}


def train_grads(module, inputs, call_kw):
    """A training-mode forward and backward of sum(out * cot), the first
    input taking a gradient too: ({name: gradient}, the input's gradient).
    The cotangent is drawn on the card from the seed, whatever the device."""
    import torch

    module.train()
    module.zero_grad(set_to_none=True)
    x0 = inputs[0].clone().requires_grad_()
    out = module(x0, *inputs[1:], **call_kw)
    feat = out[-1] if isinstance(out, tuple) else out
    cot = torch.randn(feat.shape, generator=torch.Generator("cuda").manual_seed(SEED),
                      device="cuda").to(feat.device)
    (feat.float() * cot).sum().backward()
    module.eval()
    return {n: p.grad.clone() for n, p in module.named_parameters()}, x0.grad


def grads_checked(module, inputs, call_kw, label: str) -> str:
    """The card's training-mode gradients (``train_grads``) against the
    same module's on the CPU, as max abs over max(largest |g| of the
    module's parameters, 1), the input's over its own: every gradient
    finite; within ``GRAD_BAR``, and the same with TF32 on (the control)
    above it; every parameter's nonzero but the true-zero leaves'
    (``true_zero_leaves``), whose readings are printed. Returns a summary."""
    import copy

    import torch

    cpu_module = copy.deepcopy(module).cpu()
    grads, x_grad = train_grads(module, inputs, call_kw)
    with tf32_on():
        tf32, x_tf32 = train_grads(module, inputs, call_kw)
    torch.cuda.synchronize()
    bad = [n for n, g in grads.items() if g is None or not bool(torch.isfinite(g).all())]
    check(not bad and bool(torch.isfinite(x_grad).all()),
          f"{label}: gradients not finite: {bad[:5]}, input finite "
          f"{bool(torch.isfinite(x_grad).all())}")
    ref, x_ref = train_grads(cpu_module, [a.cpu() for a in inputs], call_kw)
    scale = max(max(float(g.abs().max()) for g in ref.values()), 1.0)
    x_scale = max(float(x_ref.abs().max()), 1.0)

    def gaps(got, x_got):
        per = {n: float((g.cpu() - ref[n]).abs().max()) / scale for n, g in got.items()}
        worst = max(per, key=per.get)
        return per[worst], worst, float((x_got.cpu() - x_ref).abs().max()) / x_scale

    gap, worst, x_gap = gaps(grads, x_grad)
    ctl, ctl_worst, x_ctl = gaps(tf32, x_tf32)
    check(max(gap, x_gap) <= GRAD_BAR < max(ctl, x_ctl),
          f"{label}: card gradients against the CPU's: {gap} at {worst}, the input's {x_gap}; "
          f"with TF32 on {ctl} at {ctl_worst}, the input's {x_ctl} (bar {GRAD_BAR} between)")
    zeros = true_zero_leaves(module)
    check(zeros <= set(grads), f"{label}: true-zero leaves {sorted(zeros - set(grads))}")
    zero = [n for n, g in grads.items() if n not in zeros and not bool(g.abs().max() > 0)]
    check(not zero, f"{label}: zero gradients {zero}")
    rest = [n for n in grads if n not in zeros]
    smallest = min(rest, key=lambda n: float(grads[n].abs().max()))
    noise = ", ".join(f"{n} {float(grads[n].abs().max()):.3e}" for n in sorted(zeros))
    return (f"{len(grads)} parameter gradients finite; against the CPU's, max abs / max(largest "
            f"|g|, 1) ({scale:.3e}) {gap:.3e} ({worst}), the input's {x_gap:.3e}; with TF32 on "
            f"(the control) {ctl:.3e} ({ctl_worst}), the input's {x_ctl:.3e} (bar {GRAD_BAR}); "
            f"{len(rest)} nonzero (smallest max |g| {float(grads[smallest].abs().max()):.3e}, "
            f"{smallest}); {len(zeros)} true-zero Dense biases before a batch-statistics norm, "
            f"max |g| on the card: {noise}")


def dist_mode_phase(ctx, grids, path_launches: dict) -> None:
    """Phase 33 (a): dist_mode ProjectPointNet and ProjSetUpconv at the
    shipped geometries."""
    import copy

    import torch

    from i2pnet_tpu_torch.models import init_random_
    from i2pnet_tpu_torch.nn.proj_backbone import ProjectPointNet, ProjSetUpconv
    from i2pnet_tpu_torch.ops import select_cuda
    from i2pnet_tpu_torch.ops.projection import strided_downsample

    cfg, raw_grid, xyz_grid, norm_grid = grids
    level = dict(out_h=cfg.lidar_Hs[0], out_w=cfg.lidar_Ws[0], stride_h=cfg.stride_Hs[0],
                 stride_w=cfg.stride_Ws[0], kernel_size=tuple(cfg.kernel_sizes[0]),
                 nsample=cfg.lidar_group_samples[0], distance=cfg.down_conv_dis[0],
                 mlp=tuple(cfg.lidar_encoder_mlps[0]))
    check(level == DIST_LEVEL, f"phase 33: lidar_lv1 geometry {level}")
    gen = torch.Generator().manual_seed(SEED + 33)
    f32 = init_random_(ProjectPointNet(in_channels=1, **level), gen)
    bf16 = ProjectPointNet(in_channels=1, dtype=torch.bfloat16, **level)
    bf16.load_state_dict(f32.state_dict())
    f32, bf16 = f32.to(ctx.dev).eval(), bf16.to(ctx.dev).eval()
    inputs = (raw_grid, xyz_grid, norm_grid)
    dist = {"dist_mode": True}
    with torch.no_grad():
        reset_counts()
        with Captures([ctx.select]) as caps:
            out = bf16(*inputs, **dist)
        torch.cuda.synchronize()
        counts = read_counts()
        path_launches["dist_mode_dense_eval"] = counts
        print(f"phase 33 dist_mode lidar_lv1 (B={BATCH}, 64x1800 -> 16x225, kernel (9, 15), K=32) "
              f"bf16 eval: launches {compact(counts)} on {ctx.card}")
        check(counts == DIST_LAUNCHES, f"phase 33 dist_mode launches {counts}")
        feat = out[2]
        check(tuple(feat.shape) == (BATCH, 16, 225, 32) and bool(torch.isfinite(feat).all()),
              f"phase 33 dist_mode: {tuple(feat.shape)}, finite {bool(torch.isfinite(feat).all())}")
        eval_kernel_error("select", select_cuda.selection_multiplicity_plain, caps["select"].calls)
        bf16_ms, spread = windows_ms(lambda: bf16(*inputs, **dist))
        dense = f32(*inputs, **dist)[2]
        os.environ["I2PNET_PROJ_DENSE_EVAL"] = "0"
        try:
            gathered = f32(*inputs, **dist)[2]
            f32_gathered_ms, _ = windows_ms(lambda: f32(*inputs, **dist))
        finally:
            del os.environ["I2PNET_PROJ_DENSE_EVAL"]
        f32_dense_ms, _ = windows_ms(lambda: f32(*inputs, **dist))
    gap = float((dense - gathered).abs().max())
    check(torch.allclose(dense, gathered, rtol=DENSE_BAR, atol=DENSE_BAR),
          f"phase 33 dist_mode: f32 dense against gathered max abs {gap}")
    bf_gap = float((feat.float() - dense).abs().max())
    check(bf_gap <= BF16_BAR * float(dense.abs().max()), f"phase 33 dist_mode bf16: {bf_gap}")
    print(f"phase 33 dist_mode lidar_lv1: f32 dense against f32 gathered max abs {gap:.3e} "
          f"(rtol = atol = {DENSE_BAR}; max |out| {float(dense.abs().max()):.3f}); bf16 dense "
          f"against f32 {bf_gap:.3e}; eager ms a forward: bf16 dense {bf16_ms:.3f} (spread "
          f"{spread:.1f}%), f32 dense {f32_dense_ms:.3f}, f32 gathered {f32_gathered_ms:.3f} on "
          f"{ctx.card}")
    print(f"phase 33 dist_mode lidar_lv1 train (gathered, f32): "
          f"{grads_checked(f32, inputs, dist, 'phase 33 dist_mode level')} on {ctx.card}")

    # the first upconv: fine 4x57 from coarse 4x29, the model's widths
    up = dict(out_h=cfg.lidar_Hs[2], out_w=cfg.lidar_Ws[2], stride_h=cfg.stride_Hs[3],
              stride_w=cfg.stride_Ws[3], kernel_size=tuple(cfg.up_conv_kernel_size[0]),
              nsample=cfg.setupconv_nsamples[0], distance=cfg.up_conv_dis[0],
              mlp=tuple(cfg.setupconv_mlps[0][0]), mlp2=tuple(cfg.setupconv_mlps[0][1]))
    check(up == DIST_UPCONV, f"phase 33: first upconv geometry {up}")
    raws, xyzs = [raw_grid], [xyz_grid]
    for i in range(4):
        args = (cfg.lidar_Hs[i], cfg.lidar_Ws[i], cfg.stride_Hs[i], cfg.stride_Ws[i])
        raws.append(strided_downsample(raws[-1], *args))
        xyzs.append(strided_downsample(xyzs[-1], *args))
    C3, F2 = cfg.lidar_encoder_mlps[2][-1], cfg.flow_predictor_mlps[0][-1]
    feat1 = torch.randn(BATCH, 4, 57, C3, generator=gen)
    feat2 = torch.randn(BATCH, 4, 29, F2, generator=gen)
    upconv = init_random_(ProjSetUpconv(feat2_channels=F2, feat1_channels=C3, dist_mode=True,
                                        **up), gen).eval()
    up_bf16 = ProjSetUpconv(feat2_channels=F2, feat1_channels=C3, dist_mode=True,
                            dtype=torch.bfloat16, **up)
    up_bf16.load_state_dict(upconv.state_dict())
    up_inputs = [raws[3], raws[4], xyzs[3], xyzs[4]]
    with torch.no_grad():
        ref = upconv(*[a.cpu() for a in up_inputs], feat1, feat2, **dist)
        card_up = copy.deepcopy(upconv).to(ctx.dev)
        got = card_up(*up_inputs, feat1.to(ctx.dev), feat2.to(ctx.dev), **dist)
        got_bf16 = up_bf16.to(ctx.dev).eval()(*up_inputs, feat1.to(ctx.dev), feat2.to(ctx.dev),
                                                **dist)
        with tf32_on():
            got_tf32 = card_up(*up_inputs, feat1.to(ctx.dev), feat2.to(ctx.dev), **dist)
    scale = max(float(ref.abs().max()), 1.0)
    up_gap = float((got.cpu() - ref).abs().max()) / scale
    up_tf32 = float((got_tf32.cpu() - ref).abs().max()) / scale
    up_bf = float((got_bf16.float() - got).abs().max()) / scale
    check(tuple(got.shape) == (BATCH, 4 * 57, 64) and up_gap <= CARD_CPU_BAR < up_tf32
          and up_bf <= BF16_BAR and bool(torch.isfinite(got_bf16).all()),
          f"phase 33 dist_mode upconv: shape {tuple(got.shape)}, card against CPU {up_gap}, "
          f"with TF32 on {up_tf32} (bar {CARD_CPU_BAR} between them), bf16 {up_bf}")
    trained = grads_checked(card_up, up_inputs + [feat1.to(ctx.dev), feat2.to(ctx.dev)], dist,
                            "phase 33 dist_mode upconv")
    print(f"phase 33 dist_mode upconv (4x57 from 4x29, kernel (5, 9), K=8, widths {F2} + "
          f"{C3}): f32 on the card against the CPU, max abs / max(|ref|, 1) ({scale:.3f}): "
          f"{up_gap:.3e} with TF32 off, {up_tf32:.3e} with TF32 on (the control; bar "
          f"{CARD_CPU_BAR}); bf16 against f32 {up_bf:.3e}; train (f32): {trained} on {ctx.card}")


def init_resnet_(model, gen):
    """Seeded weights for the ResNet encoder: He-normal convolutions (no
    biases), BatchNorm affines and running statistics near their neutral
    values, as ``init_random_`` draws them, on the CPU in module order."""
    import torch

    from i2pnet_tpu_torch.nn.layers import BatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * (2.0 / m.weight[0].numel()) ** 0.5)
            elif isinstance(m, BatchNorm):
                n = m.weight.numel()
                m.weight.copy_(1.0 + 0.1 * torch.randn(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
    return model


def resnet_phase(ctx) -> None:
    """Phase 33 (b): ResNet-34 at B=8, 384x1280: the card's f32 eval output
    against the CPU's with TF32 off and on (the control), bf16 against f32,
    eager and graph-replayed forwards, a train step's ms and peak memory, in
    both dtypes."""
    import copy

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from i2pnet_tpu_torch.nn import ResNetEncoder

    gen = torch.Generator().manual_seed(SEED + 34)
    model = init_resnet_(ResNetEncoder(), gen).eval()
    x_cpu = torch.randn(BATCH, IMG_H, IMG_W, 3, generator=gen)
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = model(x_cpu)
    cpu_s = time.perf_counter() - t0
    x = x_cpu.to(ctx.dev)
    models = {"f32": copy.deepcopy(model).to(ctx.dev).eval()}
    models["bf16"] = ResNetEncoder(dtype=torch.bfloat16)
    models["bf16"].load_state_dict(model.state_dict())
    models["bf16"] = models["bf16"].to(ctx.dev).eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        outs = {"f32": models["f32"](x)}
    flops = counter.get_total_flops()
    with torch.no_grad():
        outs["bf16"] = models["bf16"](x)
        with tf32_on():
            tf32 = models["f32"](x)
    torch.cuda.synchronize()
    shapes = [tuple(o.shape) for o in outs["f32"]]
    check(shapes == [(BATCH, -(-IMG_H // s), -(-IMG_W // s), c)
                     for s, c in ((8, 128), (16, 256), (32, 512))],
          f"phase 33 ResNet-34 pyramid {shapes}")
    gaps = []
    for r, g, c, b in zip(ref, outs["f32"], tf32, outs["bf16"]):
        scale = max(float(r.abs().max()), 1.0)
        gaps.append([float((g.cpu() - r).abs().max()) / scale,
                     float((c.cpu() - r).abs().max()) / scale,
                     float((b.float() - g).abs().max()) / scale])
        check(bool(torch.isfinite(b).all()), "phase 33 ResNet-34 bf16 output not finite")
    check(all(f32 <= CARD_CPU_BAR < on and bf <= BF16_BAR for f32, on, bf in gaps),
          f"phase 33 ResNet-34: (card f32 against CPU f32, the same with TF32 on, bf16 against "
          f"f32) / max(|ref|, 1) {gaps}")
    print(f"phase 33 ResNet-34 (B={BATCH}, {IMG_H}x{IMG_W}): C3/C4/C5 {shapes}; card f32 eval "
          f"against the CPU's, max abs / max(|ref|, 1): "
          f"{', '.join(f'{g[0]:.3e}' for g in gaps)} with TF32 off, "
          f"{', '.join(f'{g[1]:.3e}' for g in gaps)} with TF32 on (the control; bar "
          f"{CARD_CPU_BAR} between them); bf16 against f32: "
          f"{', '.join(f'{g[2]:.3e}' for g in gaps)} (bar {BF16_BAR}); the CPU forward "
          f"{cpu_s:.1f} s; {flops / 1e12:.4f} TFLOP a forward (FlopCounterMode) on {ctx.card}")
    for name in ("bf16", "f32"):
        m = models[name]
        peak = BF16_FLOPS if name == "bf16" else F32_FLOPS
        with torch.no_grad():
            eager_ms, spread = windows_ms(lambda: m(x))
            graph_ms = cuda_ms(graph_of(lambda: m(x)).replay, ITERS)
        cot = [torch.randn(o.shape, generator=torch.Generator(ctx.dev).manual_seed(SEED),
                           device=ctx.dev) for o in outs["f32"]]
        m.train()
        buffers0 = {n: b.clone() for n, b in m.named_buffers()}

        def step():
            m.zero_grad(set_to_none=True)
            out = m(x)
            sum((o * c).sum() for o, c in zip(out, cot)).backward()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        bad = [n for n, p in m.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
        moved = all(not torch.equal(b, buffers0[n]) for n, b in m.named_buffers())
        check(not bad and moved, f"phase 33 ResNet-34 {name} train: gradients {bad[:5]}, "
                                 f"statistics moved {moved}")
        train_ms, train_spread = windows_ms(step, TRAIN_ITERS)
        m.eval()
        bound_ms = flops / peak * 1e3
        print(f"phase 33 ResNet-34 {name} (B={BATCH}, {IMG_H}x{IMG_W}): eval forward "
              f"{eager_ms:.3f} ms eager (median of {WINDOWS}x{ITERS}, spread {spread:.1f}%), "
              f"{graph_ms:.3f} ms under CUDA-graph replay, bound {bound_ms:.3f} ms "
              f"(operations at {peak / 1e12:.0f} TFLOP/s; {100.0 * bound_ms / graph_ms:.1f}% "
              f"of it replayed); train forward + backward {train_ms:.3f} ms (median of "
              f"{WINDOWS}x{TRAIN_ITERS}, spread {train_spread:.1f}%), every gradient finite and "
              f"every running statistic moved, peak memory {peak_gib:.2f} GiB on {ctx.card}")


@contextlib.contextmanager
def grid_builder(name: str):
    """The grid select's candidate builder inside the block: "default"
    (``window_candidates`` at every geometry) or "im2col" (where the
    geometry allows it)."""
    from i2pnet_tpu_torch.ops import projection as P

    saved = P._patches_eligible
    if name == "default":
        P._patches_eligible = lambda *args: False
    try:
        yield
    finally:
        P._patches_eligible = saved


BUILDERS = ("default", "im2col", "im2col", "default")
# a grid's gradient through the two builders, over its max |g|: f32 sums
# in another order, bf16 two units in the last place
SITE_GRAD_BARS = {"float32": 1e-5, "bfloat16": 2.0**-6}


def grid_ops_phase(ctx, grids) -> None:
    """Phase 33 (c): the generic window select and gather_grid against the
    grid select at the lidar_lv1 geometry, and the im2col candidate builder
    against the default, bit for bit and timed."""
    import torch

    from i2pnet_tpu_torch.ops import projection as P

    cfg, raw_grid, xyz_grid, _ = grids
    out_h, out_w, qs = cfg.lidar_Hs[0], cfg.lidar_Ws[0], (cfg.stride_Hs[0], cfg.stride_Ws[0])
    kernel, K, dist = tuple(cfg.kernel_sizes[0]), cfg.lidar_group_samples[0], cfg.down_conv_dis[0]
    wargs = dict(out_h=out_h, out_w=out_w, qstride=qs, stride=(1, 1), kernel_size=kernel,
                 shift=True)
    feats = (raw_grid, xyz_grid)

    def grid_select():
        args, mask = P.window_neighbor_select_grid(xyz_grid, xyz_grid, out_h, out_w, qs, kernel,
                                                   K, (1, 1), dist, True, True)
        return [args, mask] + [P.select_window_features(g, args, **wargs) for g in feats]

    def generic_select():
        idx = P.strided_grid_indices(BATCH, out_h, out_w, *qs, device=ctx.dev)
        h, w, mask = P.window_neighbor_select(xyz_grid, xyz_grid, idx, kernel, K, (1, 1), dist,
                                              True, True)
        return [mask] + [P.gather_grid(g, h, w) for g in feats]

    runs, ms = {}, {}
    with torch.no_grad():
        generic = generic_select()
        ms["generic"] = replay_ms(generic_select)
        for name in ("default", "im2col"):
            with grid_builder(name):
                check(P._patches_eligible(out_h, out_w, qs, (1, 1), *xyz_grid.shape[1:3], True)
                      == (name == "im2col"), f"phase 33: the im2col builder's gate ({name})")
                runs[name] = grid_select()
                ms[name] = replay_ms(grid_select)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(generic, runs["default"][1:])),
          "phase 33: the generic select and gather_grid differ from the grid select")
    check(all(torch.equal(a, b) for a, b in zip(runs["default"], runs["im2col"])),
          "phase 33: the im2col builder differs from the default builder")
    hits = float(runs["default"][1].mean())
    print(f"phase 33 grid ops at lidar_lv1 (B={BATCH}, 64x1800 -> {out_h}x{out_w}, kernel "
          f"{kernel}, K={K}, copy): window_neighbor_select + gather_grid at strided_grid_indices "
          f"equal to window_neighbor_select_grid + select_window_features (masks, and the raw and "
          f"warped grids' features in every slot; mask mean {hits:.4f}); the im2col builder's "
          f"args, masks and features bit-identical to the default's on {ctx.card}")
    print(f"phase 33 grid ops, select and two feature gathers (graph replay): default builder "
          f"{ms['default']:.4f} ms, im2col builder {ms['im2col']:.4f} ms, generic select + "
          f"gather_grid {ms['generic']:.4f} ms on {ctx.card}")


def builders_on_proj_model(ctx) -> None:
    """Phase 33 (d): the two candidate builders on the shipped proj model
    in bf16 at B=8 on phase 10's inputs. Every ``select_window_features``
    call site of a train step and an eval forward, alone: the features equal
    under both builders and, where the grid takes a gradient, its gradient
    within ``SITE_GRAD_BARS`` (repeated slots summed in another order); the
    forward replayed and the forward and backward replayed, timed with
    each. Then the whole eval forward (replayed) and train step (eager)
    under each: outputs and loss bit-identical, the gradients' largest gaps
    printed, timed in the order ``BUILDERS``. im2col is the port's builder
    wherever the geometry allows, on these readings."""
    import torch
    from torch.utils._pytree import tree_leaves

    from i2pnet_tpu_torch.config import I2PNetProjConfig
    from i2pnet_tpu_torch.models import I2PNetProj, init_random_
    from i2pnet_tpu_torch.ops import projection as P
    from i2pnet_tpu_torch.train import create_train_state, make_train_step_proj

    pcfg = dataclasses.replace(I2PNetProjConfig(), compute_dtype="bfloat16")
    pinputs = make_proj_inputs(ctx.dev)
    rgb, lidar, raw, k = pinputs
    batch = {"rgb": rgb, "lidar": lidar, "raw_xyz": raw, "intrinsic": k,
             "decalib_q_gt": torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=ctx.dev).repeat(BATCH, 1),
             "decalib_t_gt": torch.zeros(BATCH, 3, device=ctx.dev)}

    def train_setup():
        m = init_random_(I2PNetProj(pcfg), torch.Generator().manual_seed(SEED))
        st = create_train_state(m, steps_per_epoch=100)
        return m, st, make_train_step_proj(m, pcfg), torch.Generator(ctx.dev).manual_seed(SEED)

    sites, plain = {}, P.select_window_features

    def record(feat_grid, args, **wargs):
        key = (tuple(feat_grid.shape), str(feat_grid.dtype).split(".")[-1],
               feat_grid.requires_grad, wargs["out_h"], wargs["out_w"], tuple(wargs["qstride"]),
               tuple(wargs["stride"]), tuple(wargs["kernel_size"]))
        sites.setdefault(key, (args.detach().clone(), dict(wargs)))
        return plain(feat_grid, args, **wargs)

    steps = {}
    for name in ("default", "im2col"):
        m, st, step, gen = train_setup()
        with grid_builder(name):
            P.select_window_features = record
            try:
                metrics = step(st, batch, gen)
            finally:
                P.select_window_features = plain
        torch.cuda.synchronize()
        steps[name] = [metrics["loss"].clone()] + [p.grad.clone() for p in m.parameters()]
        names, zeros = [n for n, _ in m.named_parameters()], true_zero_leaves(m)
        del m, st, step
    check(torch.equal(steps["default"][0], steps["im2col"][0])
          and all(bool(torch.isfinite(g).all()) for g in steps["im2col"][1:]),
          "phase 33: a proj train step's loss differs between the builders, or a gradient is "
          "not finite")
    largest = max(float(g.abs().max()) for g in steps["default"][1:])
    grad_gaps = {n: (float((a - b).abs().max()), float(a.abs().max()))
                 for n, a, b in zip(names, steps["default"][1:], steps["im2col"][1:])}
    n_equal = sum(g == 0.0 for g, _ in grad_gaps.values())

    def worst(keys):
        k = max(keys, key=lambda n: grad_gaps[n][0] / max(grad_gaps[n][1], 1e-2 * largest))
        gap, leaf = grad_gaps[k]
        return f"{gap:.3e} at {k} (its max |g| {leaf:.3e})"

    print(f"phase 33 builders, a proj train step: loss bit-identical; {n_equal} of "
          f"{len(grad_gaps)} gradients bit-identical; largest |g| {largest:.3e}; the largest gap "
          f"over a leaf's max |g| (at least 1e-2 of the largest): "
          f"{worst([n for n in grad_gaps if n not in zeros])}; over the true-zero leaves "
          f"{worst([n for n in grad_gaps if n in zeros])} on {ctx.card}")
    model = init_random_(I2PNetProj(pcfg), torch.Generator().manual_seed(SEED)).eval()
    outs = {}
    with torch.no_grad():
        for name in ("default", "im2col"):
            with grid_builder(name):
                P.select_window_features = record
                try:
                    outs[name] = [o for o in tree_leaves(model(*pinputs))
                                  if isinstance(o, torch.Tensor)]
                finally:
                    P.select_window_features = plain
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(outs["default"], outs["im2col"])),
          "phase 33: the proj eval forward differs between the builders")

    totals = {name: [0.0, 0.0] for name in ("default", "im2col")}
    gen = torch.Generator(ctx.dev).manual_seed(SEED + 35)
    for (shape, dtype, grad, out_h, out_w, qs, stride, kernel), (args, wargs) in sites.items():
        h2, w2 = shape[1:3]
        with grid_builder("im2col"):
            eligible = P._patches_eligible(out_h, out_w, qs, stride, h2, w2, wargs["shift"])
        if not eligible:
            print(f"phase 33 builders, site grid {shape} {dtype} -> {out_h}x{out_w}, qstride "
                  f"{qs}, stride {stride}, kernel {kernel}: the default builder alone (stride or "
                  f"geometry) on {ctx.card}")
            continue
        grid = torch.randn(shape, generator=gen, device=ctx.dev).to(getattr(torch, dtype))
        grid.requires_grad_(grad)
        cot = torch.randn(tuple(args.shape) + shape[-1:], generator=gen, device=ctx.dev)
        fwd = {name: [] for name in totals}
        bwd = {name: [] for name in totals}
        feats = {}
        for name in BUILDERS:
            with grid_builder(name):
                with torch.no_grad():
                    feats[name] = plain(grid, args, **wargs)
                    fwd[name].append(replay_ms(lambda: plain(grid, args, **wargs)))
                if grad:
                    bwd[name].append(replay_ms(lambda: torch.autograd.grad(
                        (plain(grid, args, **wargs).float() * cot).sum(), grid)))
        check(torch.equal(feats["default"], feats["im2col"]),
              f"phase 33 builders: site {shape} features differ")
        grad_gap = None
        if grad:
            got = {}
            for name in ("default", "im2col"):
                with grid_builder(name):
                    got[name] = torch.autograd.grad(
                        (plain(grid, args, **wargs).float() * cot).sum(), grid)[0].float()
            grad_gap = float((got["im2col"] - got["default"]).abs().max()) / float(
                got["default"].abs().max())
            check(grad_gap <= SITE_GRAD_BARS[dtype],
                  f"phase 33 builders: site {shape} {dtype} gradients {grad_gap}")
        for name in totals:
            totals[name][0] += statistics.median(fwd[name])
            totals[name][1] += statistics.median(bwd[name]) if grad else 0.0
        print(f"phase 33 builders, site grid {shape} {dtype} -> {out_h}x{out_w}, qstride {qs}, "
              f"kernel {kernel}, K={args.shape[-1]}: forward (graph replay) default "
              f"{'/'.join(f'{t:.4f}' for t in fwd['default'])} ms, im2col "
              f"{'/'.join(f'{t:.4f}' for t in fwd['im2col'])}"
              + (f"; forward + backward (graph replay) default "
                 f"{'/'.join(f'{t:.4f}' for t in bwd['default'])} ms, im2col "
                 f"{'/'.join(f'{t:.4f}' for t in bwd['im2col'])}; the grid's gradients "
                 f"{grad_gap:.3e} of max |g| apart (bar {SITE_GRAD_BARS[dtype]:.3e})" if grad
                 else "")
              + f"; features equal on {ctx.card}")
    print(f"phase 33 builders, the eligible sites summed (medians): forward default "
          f"{totals['default'][0]:.4f} ms, im2col {totals['im2col'][0]:.4f}; forward + backward "
          f"default {totals['default'][1]:.4f} ms, im2col {totals['im2col'][1]:.4f} on {ctx.card}")

    fwd_ms = {name: [] for name in totals}
    step_ms = {name: [] for name in totals}
    m, st, step, sgen = train_setup()
    with torch.no_grad():
        for name in BUILDERS:
            with grid_builder(name):
                fwd_ms[name].append(replay_ms(lambda: model(*pinputs)))
    for name in BUILDERS:
        with grid_builder(name):
            step(st, batch, sgen)
            step_ms[name].append(windows_ms(lambda: step(st, batch, sgen), TRAIN_ITERS)[0])
    print(f"phase 33 builders on the shipped proj model (bf16, B={BATCH}), in the order "
          f"{'/'.join(BUILDERS)}: eval forward (graph replay) default "
          f"{'/'.join(f'{t:.3f}' for t in fwd_ms['default'])} ms, im2col "
          f"{'/'.join(f'{t:.3f}' for t in fwd_ms['im2col'])}; train step (eager, median of "
          f"{WINDOWS}x{TRAIN_ITERS}) default {'/'.join(f'{t:.3f}' for t in step_ms['default'])} "
          f"ms, im2col {'/'.join(f'{t:.3f}' for t in step_ms['im2col'])}; outputs and loss "
          f"bit-identical on {ctx.card}")


def code_no_model_runs_phase(ctx, path_launches: dict) -> None:
    """Phase 33: (a) dist_mode, (b) ResNet-34, (c) the grid ops, (d) the
    candidate builders on the proj model."""
    t0 = time.perf_counter()
    grids = proj_range_images(ctx.dev)
    dist_mode_phase(ctx, grids, path_launches)
    t1 = time.perf_counter()
    resnet_phase(ctx)
    t2 = time.perf_counter()
    grid_ops_phase(ctx, grids)
    del grids
    t3 = time.perf_counter()
    builders_on_proj_model(ctx)
    print(f"phase 33: dist_mode {t1 - t0:.1f} s, ResNet-34 {t2 - t1:.1f} s, grid ops "
          f"{t3 - t2:.1f} s, the builders on the proj model {time.perf_counter() - t3:.1f} s on "
          f"{ctx.card}")


def sweep_inputs(device, B: int = BATCH, seed: int = 3000000019):
    """The proj model's inputs from the benchmark's large-range sweep
    (``h100_bench/gen.py``, traffic ``lr-eval``): (rgb, cloud, raw cloud,
    intrinsic), B rows."""
    import torch

    from h100_bench import gen

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "h100_bench")
    with open(os.path.join(root, "configs", "i2pnet-proj-kitti-lr.json")) as f:
        config = json.load(f)
    with open(os.path.join(root, "traffic", "lr-eval.json")) as f:
        traffic = dict(json.load(f), batch=B)
    b = {k: torch.from_numpy(v).to(device)
         for k, v in gen.model_keys(gen.make_batch(seed, 0, config, traffic)).items()}
    return b["rgb"], b["lidar"], b["raw_xyz"], b["intrinsic"]


DENSE_LEVELS = ("lidar_lv1", "lidar_lv2", "lidar_lv3", "lidar_lv4", "layer_idx")


def dense_level_calls(model, inputs) -> list:
    """Each dense level's call in one eval forward of the proj model on
    inputs, without gradient: [(name, module, args, kwargs)], in the order
    of ``DENSE_LEVELS``."""
    import torch

    calls = []
    hooks = [getattr(model, name).register_forward_pre_hook(
        lambda mod, a, kw, name=name: calls.append((name, mod, a, kw)), with_kwargs=True)
        for name in DENSE_LEVELS]
    try:
        with torch.no_grad():
            model(*inputs)
    finally:
        for h in hooks:
            h.remove()
    return calls


def dense_level_bound(mod, args, kwargs, out) -> float:
    """A dense level's bound (s): its inputs read once (the grids, m, the
    weights) and its features written once at 3.35 TB/s, or each selected
    slot's MLP once (no recomputation) at the bf16 peak."""
    from i2pnet_tpu_torch.ops import dense_window

    xyz_raw, xyz, feature = args[:3]
    m = dense_window.window_multiplicity(
        xyz if mod.use_trans else xyz_raw, out_h=mod.out_h, out_w=mod.out_w, qstride=mod.stride,
        kernel_size=mod.kernel_size, K=mod.nsample, distance=mod.distance)
    rows = float((m > 0).sum())
    layers = mod.mlp_convs.layers
    flops = rows * sum(2.0 * c.Dense_0.in_features * c.Dense_0.out_features for c in layers)
    weights = sum(p.numel() * p.element_size() for p in mod.parameters())
    grids = sum(t.numel() * t.element_size() for t in (xyz_raw, xyz, feature))
    byte_count = grids + m.numel() * 4 + weights + out.numel() * 4
    return max(byte_count / HBM_BYTES_PER_S, flops / BF16_FLOPS)


def dense_level_phase(ctx) -> dict:
    """Phase 34: the dense eval level kernel (``csrc/dense_level.cu``) at
    every dense level of the shipped bf16 proj model (``lidar_lv1-4``,
    ``layer_idx``), on chip_smoke's proj inputs and on the benchmark's
    sweep: every level of the forward on the kernel; each call's launches,
    counted (2L + 1), and its features against the plain chain's (0.01 *
    max(|ref|, 1)); on the sweep each level timed by graph replay beside
    the plain chain and its bound."""
    import torch

    from i2pnet_tpu_torch.config import I2PNetProjConfig
    from i2pnet_tpu_torch.models import I2PNetProj, init_random_
    from i2pnet_tpu_torch.ops import dense_level_cuda

    pcfg = dataclasses.replace(I2PNetProjConfig(), compute_dtype="bfloat16")
    model = init_random_(I2PNetProj(pcfg), torch.Generator().manual_seed(SEED)).eval()
    rows = {}
    for label, inputs in (("bench", make_proj_inputs(ctx.dev)),
                          ("sweep", sweep_inputs(ctx.dev))):
        routes = dict(dense_level_cuda.routes)
        calls = dense_level_calls(model, inputs)
        torch.cuda.synchronize()
        moved = {k: v - routes.get(k, 0) for k, v in dense_level_cuda.routes.items()
                 if v != routes.get(k, 0)}
        check([c[0] for c in calls] == list(DENSE_LEVELS) and moved == {"kernel": 5},
              f"phase 34 {label}: dense level routes {moved}")
        for name, mod, args, kwargs in calls:
            with torch.no_grad():
                before = dense_level_cuda.launches
                got = mod(*args, **kwargs)[2]
                launches = dense_level_cuda.launches - before
                check(launches == 2 * len(mod.mlp_convs.layers) + 1,
                      f"phase 34 {label} {name}: {launches} launches")
                real = dense_level_cuda.refusal
                dense_level_cuda.refusal = lambda *a: "plain"
                try:
                    ref = mod(*args, **kwargs)[2]
                    plain_ms = replay_ms(lambda: mod(*args, **kwargs)) if label == "sweep" else None
                finally:
                    dense_level_cuda.refusal = real
                err = float((got - ref).abs().max())
                bar = 0.01 * max(float(ref.abs().max()), 1.0)
                check(err <= bar, f"phase 34 {label} {name}: max abs err {err} above {bar}")
                row = {"launches": launches, "max_abs_err": err}
                if label == "sweep":
                    rows[name] = row = dict(
                        row, ms=replay_ms(lambda: mod(*args, **kwargs)), plain_ms=plain_ms,
                        bound_ms=1e3 * dense_level_bound(mod, args, kwargs, got))
            print(f"phase 34 {label} {name}: {json.dumps(row)} on {ctx.card}")
        del calls
    total = {k: sum(r[k] for r in rows.values()) for k in ("ms", "plain_ms", "bound_ms")}
    print(f"phase 34: the five dense levels of a stage (sweep, B={BATCH}, graph replay, the "
          f"select kernel included): kernel {total['ms']:.3f} ms, plain chain "
          f"{total['plain_ms']:.3f} ms, bound {total['bound_ms']:.4f} ms on {ctx.card}")
    print(json.dumps({"dense_level": rows}))
    return rows


def eval_kernel_table():
    """The eval kernels, the window select and the dense level kernel, as
    ``kernel_table`` gives them, from the op library's modules alone (phase
    31's serving process imports no other)."""
    from i2pnet_tpu_torch.ops import conv_cuda, cv_cuda, dense_level_cuda, fps_cuda, select_cuda

    eval_kernels = [
        dict(name="fps", module=fps_cuda, fn="fps_cuda", plain="fps_plain", src="fps.cu",
             replaces="i2pnet_tpu/ops/fps_pallas.py:27"),
        dict(name="encoder_block", module=conv_cuda, fn="conv_block_cuda",
             plain="conv_block_plain", src="conv_block.cu",
             replaces="i2pnet_tpu/ops/conv_pallas.py:150"),
        dict(name="cv1", module=cv_cuda, fn="cv1_cuda", plain="cv1_plain", src="cv1.cu",
             replaces="i2pnet_tpu/ops/cv_pallas.py:58"),
    ]
    select = dict(name="select", module=select_cuda, fn="selection_multiplicity_cuda",
                  plain="selection_multiplicity_plain", src="select.cu",
                  replaces="i2pnet_tpu/ops/select_pallas.py:47")
    # the chain after the select in a dense eval level; no TPU kernel (the
    # JAX package's chain is plain jnp)
    dense = dict(name="dense_level", module=dense_level_cuda, fn="dense_level_pass_cuda",
                 plain="dense_level_pass_plain", src="dense_level.cu", replaces=None)
    return eval_kernels, select, dense


def kernel_table():
    """The kernels, each a dict of its name, module, wrapper (``fn``),
    plain version, source and the TPU kernel it replaces: (eval kernels,
    train kernels, the pallas backend's pair, the pool route at strides 1
    and 2, the window select, the dense level kernel)."""
    from i2pnet_tpu_torch.ops import conv_train_cuda, pool_route_cuda

    pcc = "i2pnet_tpu/ops/conv_pallas_train.py"
    eval_kernels, select, dense = eval_kernel_table()
    train_kernels = [
        dict(name="conv_fwd", src="conv_train.cu", replaces=f"{pcc}:103"),
        dict(name="conv_dx", src="conv_train.cu", replaces=f"{pcc}:103"),
        dict(name="conv_dw", src="conv_train.cu", replaces=f"{pcc}:212"),
        dict(name="bn_pool_fwd", src="bn_pool_train.cu", replaces=f"{pcc}:656"),
        dict(name="bn_pool_bwd", src="bn_pool_train.cu", replaces=f"{pcc}:801"),
    ]
    # the pallas backend's pair, which every call without a gradient also
    # takes (its forward)
    pallas_kernels = [
        dict(name="bn_pool_fwd_notap", src="bn_pool_train.cu", replaces=f"{pcc}:302"),
        dict(name="bn_pool_bwd_recompute", src="bn_pool_train.cu", replaces=f"{pcc}:397"),
    ]
    for k in train_kernels + pallas_kernels:
        k.update(module=conv_train_cuda, fn=f"{k['name']}_cuda", plain=f"{k['name']}_plain")
    route_kernels = [dict(name=f"pool_route_s{s}", module=pool_route_cuda, fn="pool_route_cuda",
                          plain="pool_route_plain", src="pool_route.cu",
                          replaces="i2pnet_tpu/nn/layers.py:165") for s in (1, 2)]
    return eval_kernels, train_kernels, pallas_kernels, route_kernels, select, dense


def _counted_modules():
    from i2pnet_tpu_torch.ops import conv_cuda, cv_cuda, dense_level_cuda, fps_cuda, select_cuda

    return {"fps": fps_cuda, "encoder_block": conv_cuda, "cv1": cv_cuda, "select": select_cuda,
            "dense_level": dense_level_cuda}


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    from i2pnet_tpu_torch.ops import conv_train_cuda, pool_route_cuda

    for mod in _counted_modules().values():
        mod.launches = 0
    for counts in (conv_train_cuda.launches, pool_route_cuda.launches):
        for key in counts:
            counts[key] = 0


def read_counts() -> dict:
    """Every kernel's launches since the last reset_counts."""
    from i2pnet_tpu_torch.ops import conv_train_cuda, pool_route_cuda

    counts = {name: mod.launches for name, mod in _counted_modules().items()}
    counts.update(conv_train_cuda.launches)
    counts.update(pool_route_cuda.launches)
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only on the card",
              file=sys.stderr)
        return 1

    from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
    from i2pnet_tpu_torch.models import I2PNet, I2PNetProj, init_random_
    from i2pnet_tpu_torch.ops import (_build, conv_cuda, conv_train_cuda, cv_cuda,
                                      dense_level_cuda, fps_cuda, pool_route_cuda, select_cuda)
    from i2pnet_tpu_torch.train import create_train_state, make_train_step, make_train_step_proj

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ct = conv_train_cuda
    eval_kernels, train_kernels, pallas_kernels, route_kernels, select, dense = kernel_table()
    all_kernels = (eval_kernels + train_kernels + [select, dense] + pallas_kernels
                   + route_kernels)

    # --- phase 1: build the kernels, name the card
    t0 = time.perf_counter()
    t_start = t0
    sources = sorted({k["src"][:-3] for k in all_kernels})
    _build.build_all(sources)
    for mod in (fps_cuda, conv_cuda, cv_cuda, conv_train_cuda, select_cuda, pool_route_cuda,
                dense_level_cuda):
        mod._lib()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(sources)} kernel libraries "
          f"(nvcc in parallel)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)

    if "--phase" in sys.argv[1:]:  # one of phases 30-34 alone, after the build
        only = sys.argv[sys.argv.index("--phase") + 1:][:1]
        phases = {"30": dp_phase, "31": export_phase,
                  "32": lambda ctx, work, _: rehearsal_phase(ctx, work),
                  "33": lambda ctx, work, pl: code_no_model_runs_phase(ctx, pl),
                  "34": lambda ctx, work, _: dense_level_phase(ctx)}
        check(len(only) == 1 and only[0] in phases,
              f"--phase {only}: only phases {sorted(phases)} run alone")
        import shutil
        import tempfile
        import types

        ctx = types.SimpleNamespace(train_kernels=train_kernels, fps=eval_kernels[0],
                                    block=eval_kernels[1], cv1=eval_kernels[2], select=select,
                                    card=card, dev=dev)
        work = tempfile.mkdtemp(prefix=f"chip_smoke_{only[0]}_")
        try:
            phases[only[0]](ctx, work, {})
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(f"chip_smoke: phase {only[0]} alone passed in {time.perf_counter() - t_start:.1f} "
              f"s, the build included")
        return 0

    # --- phase 2: the eval forward, with its kernel calls captured
    cfg = dataclasses.replace(I2PNetConfig(), compute_dtype="bfloat16")
    model = init_random_(I2PNet(cfg), torch.Generator().manual_seed(SEED)).eval()
    inputs = make_inputs(cfg, dev)
    with torch.no_grad():
        reset_counts()
        with Captures(eval_kernels) as captures:
            out = model(*inputs)
        torch.cuda.synchronize()
        counts = read_counts()
        out2 = model(*inputs)
        torch.cuda.synchronize()
    eval_launches = {k["name"]: counts[k["name"]] for k in eval_kernels}
    print(f"launches in one forward: {eval_launches}")
    check(eval_launches == {"fps": 4, "encoder_block": 15, "cv1": 1},
          f"eval launch counts {eval_launches}")
    check(all(counts[k["name"]] == 0 for k in train_kernels + [select]),
          f"train or proj kernels at free eval: {counts}")
    check_outputs(out, out2, "free eval")
    path_launches = {"free_eval": counts}

    # --- phase 3: every captured eval kernel call against its plain version
    errors = {}
    with torch.no_grad():
        for k in eval_kernels:
            errors[k["name"]] = eval_kernel_error(k["name"], getattr(k["module"], k["plain"]),
                                                  captures[k["name"]].calls)

    # --- phase 4: eval timing on the card
    def forward():
        model(*inputs)

    rows = []
    with torch.no_grad():
        forward()
        fwd_ms, spread = windows_ms(forward)
        print(f"forward: {fwd_ms:.3f} ms/batch, {BATCH * 1000.0 / fwd_ms:.2f} pairs/s "
              f"(B={BATCH}, median of {WINDOWS}x{ITERS}, spread {spread:.1f}%) on {card}")
        graph_ms = cuda_ms(graph_of(forward).replay, ITERS)
        print(f"forward under CUDA-graph replay (device-bound floor): {graph_ms:.3f} ms/batch, "
              f"{BATCH * 1000.0 / graph_ms:.2f} pairs/s on {card}")
        for k in eval_kernels:
            rows.append(kernel_row(k, eval_launches[k["name"]], errors[k["name"]],
                                   captures[k["name"]].calls, card))
        # FPS runs npoint dependent steps a call: its time per step
        fps_row = next(r for r in rows if r["name"] == "fps")
        steps = sum(a[1] for a, _ in captures["fps"].calls)
        fps_row["per_step_us"] = fps_row["ms"] * 1e3 / steps
        print(f"fps: {fps_row['per_step_us']:.4f} us per step ({steps} steps a forward) on {card}")
        fps_levels(captures["fps"].calls, card)
        cv1_row = next(r for r in rows if r["name"] == "cv1")
        cv1_row["tflops"] = sum(cv1_flops(a) for a, _ in captures["cv1"].calls) / cv1_row["ms"] / 1e9
        print(f"cv1: {cv1_row['tflops']:.1f} TFLOP/s on {card}")
        block_shapes(captures["encoder_block"].calls, card, "free")
    if "--profile" in sys.argv[1:]:
        with torch.no_grad():
            profile_run(forward, card, "forward")

    # --- phase 5: the train step, with its kernel calls captured
    del model, captures, out, out2

    def train_setup():
        tmodel = init_random_(I2PNet(cfg), torch.Generator().manual_seed(SEED))
        state = create_train_state(tmodel, steps_per_epoch=100)
        return tmodel, state, make_train_step(tmodel, cfg), torch.Generator(dev).manual_seed(SEED)

    rgb, lidar, intrinsic = inputs
    batch = {
        "rgb": rgb, "lidar": lidar, "intrinsic": intrinsic,
        "decalib_q_gt": torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev).repeat(BATCH, 1),
        "decalib_t_gt": torch.zeros(BATCH, 3, device=dev),
    }
    tmodel, state, step, gen = train_setup()
    params0 = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    buffers0 = {n: b.clone() for n, b in tmodel.named_buffers()}
    enc_bn = tmodel.rgb_encoder.RGBEncoderStage_0.BatchNorm_0
    pw_bn = tmodel.flow_predictor0.mlp_conv.PointwiseConv_0.BatchNorm_0
    pw_in = []
    hook = pw_bn.register_forward_pre_hook(lambda mod, a: pw_in.append(a[0].detach()))
    reset_counts()
    with Captures(eval_kernels + train_kernels) as captures:
        metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    train_launches = read_counts()
    path_launches["free_train"] = train_launches
    hook.remove()
    print(f"launches in one train step: {train_launches}")
    check(train_launches == TRAIN_LAUNCHES, f"train launch counts {train_launches}")
    loss1 = metrics["loss"].clone()
    check(bool(torch.isfinite(loss1)), f"first-step loss {float(loss1)}")
    print(f"first step: loss {float(loss1):.6f}, loss_q {float(metrics['loss_q']):.6f}, "
          f"loss_x {float(metrics['loss_x']):.6f}, sx {float(metrics['sx']):.6f}, "
          f"sq {float(metrics['sq']):.6f}")
    unmoved = [n for n, p in tmodel.named_parameters() if torch.equal(p.detach(), params0[n])]
    check(not unmoved, f"parameters unchanged by a step: {unmoved[:5]}")
    check(not torch.equal(tmodel.sx.detach(), params0["sx"])
          and not torch.equal(tmodel.sq.detach(), params0["sq"]), "sx/sq unchanged")
    unmoved = [n for n, b in tmodel.named_buffers() if torch.equal(b, buffers0[n])]
    check(not unmoved, f"BatchNorm statistics unchanged by a step: {unmoved[:5]}")
    # flax's momentum rule on two BatchNorms: the first encoder block (batch
    # moments of its bf16 conv output, var = mean2 - mean**2, as the fused
    # route) and a pointwise one (flax's clipped fast variance of its input)
    y0 = captures["conv_fwd"].calls[0][1].detach().float()
    mean = y0.mean((0, 1, 2))
    var = (y0 * y0).mean((0, 1, 2)) - mean * mean
    xf = pw_in[0].float().reshape(-1, pw_in[0].shape[-1])
    pw_mean = xf.mean(0)
    pw_var = torch.clamp((xf * xf).mean(0) - pw_mean * pw_mean, min=0.0)
    prefix = {enc_bn: "rgb_encoder.RGBEncoderStage_0.BatchNorm_0",
              pw_bn: "flow_predictor0.mlp_conv.PointwiseConv_0.BatchNorm_0"}
    for bn, (m, v) in ((enc_bn, (mean, var)), (pw_bn, (pw_mean, pw_var))):
        for buf, batch_stat in (("running_mean", m), ("running_var", v)):
            want = 0.9 * buffers0[f"{prefix[bn]}.{buf}"] + 0.1 * batch_stat
            got = getattr(bn, buf)
            check(torch.allclose(got, want, rtol=1e-4, atol=1e-6),
                  f"{prefix[bn]}.{buf}: max gap {float((got - want).abs().max())}")
    print("train step: loss finite; every parameter, sx, sq and BatchNorm statistic moved; "
          "running statistics follow 0.9 * old + 0.1 * batch")
    second = train_setup()
    loss1b = second[2](second[1], batch, second[3])["loss"]
    check(torch.equal(loss1, loss1b), f"a second run's first-step loss {float(loss1b)} != "
                                      f"{float(loss1)}")
    print("a second run from the same seeds: bit-identical first-step loss")
    del second

    # --- phase 6: every train kernel call of the step against its plain version
    with torch.no_grad():
        for k in train_kernels:
            name = k["name"]
            errors[name] = train_kernel_error(name, getattr(ct, k["fn"]), getattr(ct, k["plain"]),
                                              captures[name].calls)
            print(f"{name}: {len(captures[name].calls)} calls match the plain version, "
                  f"max abs err {errors[name]:.3e}")
        for args, got in captures["fps"].calls:
            check(torch.equal(got, fps_cuda.fps_plain(*args)), "train-step fps indices differ")
    print("conv_dw: every call bit-identical when repeated; bn_pool out, taps and dz exact")

    # --- phase 7: train timing on the card
    losses = []

    def train_step():
        losses.append(step(state, batch, gen)["loss"])

    train_step()
    step_ms, spread = windows_ms(train_step)
    check(bool(torch.isfinite(torch.stack(losses)).all()), "a step's loss is not finite")
    print(f"train step: {step_ms:.3f} ms/step, {BATCH * 1000.0 / step_ms:.2f} pairs/s "
          f"(B={BATCH}, median of {WINDOWS}x{ITERS}, spread {spread:.1f}%, "
          f"{len(losses) + 1} steps, every loss finite) on {card}")
    with torch.no_grad():
        for k in train_kernels:
            rows.append(kernel_row(k, train_launches[k["name"]], errors[k["name"]],
                                   captures[k["name"]].calls, card))
        dw_shapes(captures["conv_dw"].calls, card)
        for row in rows:
            if row["name"] in PER_CALL:
                row["per_call_free_step"] = train_call_shapes(
                    row["name"], captures[row["name"]].calls, card, "free step")
    if "--profile" in sys.argv[1:]:
        profile_run(train_step, card, "train_step")

    # --- phase 8: the proj eval forward, with its kernel calls captured
    del tmodel, state, step, captures
    pcfg = dataclasses.replace(I2PNetProjConfig(), compute_dtype="bfloat16")
    pmodel = init_random_(I2PNetProj(pcfg), torch.Generator().manual_seed(SEED)).eval()
    pinputs = make_proj_inputs(dev)
    block = next(k for k in eval_kernels if k["name"] == "encoder_block")
    with torch.no_grad():
        reset_counts()
        with Captures([block, select, dense]) as captures:
            out = pmodel(*pinputs)
        torch.cuda.synchronize()
        proj_launches = read_counts()
        out2 = pmodel(*pinputs)
        torch.cuda.synchronize()
    path_launches["proj_eval"] = proj_launches
    print(f"launches in one proj forward: {proj_launches}")
    check(proj_launches == PROJ_LAUNCHES, f"proj launch counts {proj_launches}")
    check_outputs(out, out2, "proj eval")

    # --- phase 9: every select, dense level and encoder-block call against its plain version
    with torch.no_grad():
        errors["select"] = eval_kernel_error("select", select_cuda.selection_multiplicity_plain,
                                             captures["select"].calls)
        errors["dense_level"] = eval_kernel_error(
            "dense_level", dense_level_cuda.dense_level_pass_plain, captures["dense_level"].calls)
        proj_block_err = eval_kernel_error("encoder_block", conv_cuda.conv_block_plain,
                                           captures["encoder_block"].calls)
    print(f"encoder block at the proj image's shapes "
          f"{sorted({tuple(a[0].shape) for a, _ in captures['encoder_block'].calls})}: "
          f"max abs err {proj_block_err:.3e}")

    # --- phase 10: proj eval timing on the card
    def proj_forward():
        pmodel(*pinputs)

    with torch.no_grad():
        proj_forward()
        pfwd_ms, spread = windows_ms(proj_forward)
        print(f"proj forward: {pfwd_ms:.3f} ms/batch, {BATCH * 1000.0 / pfwd_ms:.2f} pairs/s "
              f"(B={BATCH}, median of {WINDOWS}x{ITERS}, spread {spread:.1f}%) on {card}")
        pgraph_ms = cuda_ms(graph_of(proj_forward).replay, ITERS)
        print(f"proj forward under CUDA-graph replay: {pgraph_ms:.3f} ms/batch, "
              f"{BATCH * 1000.0 / pgraph_ms:.2f} pairs/s on {card}")
        rows.append(kernel_row(select, proj_launches["select"], errors["select"],
                               captures["select"].calls, card))
        rows[-1]["per_call_proj_forward"] = select_call_shapes(captures["select"].calls, card)
        rows.append(kernel_row(dense, proj_launches["dense_level"], errors["dense_level"],
                               captures["dense_level"].calls, card))
        proj_block_ms = replay_ms(lambda: [conv_cuda.conv_block_cuda(*a)
                                           for a, _ in captures["encoder_block"].calls])
        print(f"encoder_block proj: {proj_block_ms:.3f} ms for "
              f"{len(captures['encoder_block'].calls)} calls (graph replay) on {card}")
        block_shapes(captures["encoder_block"].calls, card, "proj")
        if "--profile" in sys.argv[1:]:
            profile_run(proj_forward, card, "proj_forward")

    # --- phase 11: the proj train step on the default (idx) backend
    del pmodel, captures, out, out2
    prgb, plidar, praw, pk = pinputs
    pbatch = {
        "rgb": prgb, "lidar": plidar, "raw_xyz": praw, "intrinsic": pk,
        "decalib_q_gt": torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev).repeat(BATCH, 1),
        "decalib_t_gt": torch.zeros(BATCH, 3, device=dev),
    }

    def proj_train_setup():
        m = init_random_(I2PNetProj(pcfg), torch.Generator().manual_seed(SEED))
        st = create_train_state(m, steps_per_epoch=100)
        return m, st, make_train_step_proj(m, pcfg), torch.Generator(dev).manual_seed(SEED)

    def launches_of(label, want, fn):
        """Run fn with the counts set to 0; check and keep its launches."""
        reset_counts()
        result = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        path_launches[label] = counts
        print(f"launches in {label}: { {k: v for k, v in counts.items() if v} }")
        check(counts == want, f"{label} launch counts {counts}")
        return result

    ptmodel, pstate, pstep, pgen = proj_train_setup()
    params0 = {n: p.detach().clone() for n, p in ptmodel.named_parameters()}
    buffers0 = {n: b.clone() for n, b in ptmodel.named_buffers()}
    with Captures(train_kernels) as captures:
        pmetrics = launches_of("proj_train", PROJ_TRAIN_LAUNCHES,
                               lambda: pstep(pstate, pbatch, pgen))
    proj_errors = {}
    with torch.no_grad():
        for k in train_kernels:
            name = k["name"]
            proj_errors[name] = train_kernel_error(name, getattr(ct, k["fn"]),
                                                   getattr(ct, k["plain"]), captures[name].calls)
            print(f"{name}: {len(captures[name].calls)} calls of the proj step match the plain "
                  f"version, max abs err {proj_errors[name]:.3e}")
    ploss1 = pmetrics["loss"].clone()
    check(bool(torch.isfinite(ploss1)), f"proj first-step loss {float(ploss1)}")
    print(f"proj first step: loss {float(ploss1):.6f}, loss_q {float(pmetrics['loss_q']):.6f}, "
          f"loss_x {float(pmetrics['loss_x']):.6f}, sx {float(pmetrics['sx']):.6f}, "
          f"sq {float(pmetrics['sq']):.6f}")
    unmoved = [n for n, p in ptmodel.named_parameters() if torch.equal(p.detach(), params0[n])]
    check(not unmoved, f"proj parameters unchanged by a step: {unmoved[:5]}")
    check(not torch.equal(ptmodel.sx.detach(), params0["sx"])
          and not torch.equal(ptmodel.sq.detach(), params0["sq"]), "proj sx/sq unchanged")
    # the proj family's only running statistics are the RGB encoder's
    check(all(n.startswith("rgb_encoder.") for n in buffers0) and len(buffers0) == 30,
          f"proj buffers {sorted(buffers0)[:4]}...")
    unmoved = [n for n, b in ptmodel.named_buffers() if torch.equal(b, buffers0[n])]
    check(not unmoved, f"RGB BatchNorm statistics unchanged by a proj step: {unmoved[:5]}")
    grads1 = {n: p.grad.clone() for n, p in ptmodel.named_parameters()}
    params1 = {n: p.detach().clone() for n, p in ptmodel.named_parameters()}
    second = proj_train_setup()
    ploss1b = second[2](second[1], pbatch, second[3])["loss"]
    check(torch.equal(ploss1, ploss1b), f"a second proj run's first-step loss {float(ploss1b)} "
                                        f"!= {float(ploss1)}")
    # the gathered route's backward accumulates repeated window slots by
    # indexing (ops/projection.py select_window_features), in a fixed
    # order on the card: the repeat is held bit for bit, gradients too
    gaps = {n: float((p.grad - grads1[n]).abs().max()) for n, p in second[0].named_parameters()}
    worst = max(gaps, key=gaps.get)
    print(f"a second proj run from the same seeds: first-step loss bit-identical; largest "
          f"gradient gap {gaps[worst]:.3e} ({worst})")
    check(gaps[worst] == 0.0, f"proj gradients differ between two runs: {gaps[worst]} at {worst}")
    check(all(torch.equal(p.detach(), params1[n]) for n, p in second[0].named_parameters()),
          "proj parameters differ after a repeated first step")
    print("proj train step: loss finite; every parameter, sx, sq and RGB BatchNorm statistic "
          "moved; a repeated first step bit-identical (loss, gradients, parameters)")
    del second, grads1, params1

    plosses = []

    def proj_train_step():
        plosses.append(pstep(pstate, pbatch, pgen)["loss"])

    proj_train_step()
    pstep_ms, spread = windows_ms(proj_train_step)
    check(bool(torch.isfinite(torch.stack(plosses)).all()), "a proj step's loss is not finite")
    print(f"proj train step: {pstep_ms:.3f} ms/step, {BATCH * 1000.0 / pstep_ms:.2f} pairs/s "
          f"(B={BATCH}, median of {WINDOWS}x{ITERS}, spread {spread:.1f}%, "
          f"{len(plosses) + 1} steps, every loss finite) on {card}")
    with torch.no_grad():
        # kernel (a) and (d) per proj step (graph replay), beside the library
        # call and the bound, and each call alone
        for row in rows:
            name = row["name"]
            if name not in PER_CALL:
                continue
            calls = captures[name].calls
            fn = getattr(ct, f"{name}_cuda")
            lib = library_calls(name, calls)
            row["proj_step"] = {
                "launches": path_launches["proj_train"][name], "max_abs_err": proj_errors[name],
                "ms": replay_ms(lambda: [fn(*a) for a, _ in calls]),
                "library_ms": replay_ms(lib) if lib is not None else None,
                "bound_ms": total_bound(name, calls)[0],
            }
            print(f"{name} proj step: {json.dumps(row['proj_step'])} on {card}")
            row["per_call_proj_step"] = train_call_shapes(name, calls, card, "proj step")
    del captures
    if "--profile" in sys.argv[1:]:
        profile_run(proj_train_step, card, "proj_train_step")

    # --- phase 12: the pallas backend: one proj step, every call of its two
    # kernels against the plain versions, and the first two stages' blocks
    # under pallas and idx bit for bit
    os.environ["I2PNET_POOL_BWD"] = "pallas"
    with Captures(pallas_kernels) as captures:
        launches_of("proj_train_pallas", PROJ_PALLAS_LAUNCHES, lambda: pstep(pstate, pbatch, pgen))
    with torch.no_grad():
        for k in pallas_kernels:
            errors[k["name"]] = train_kernel_error(k["name"], getattr(ct, k["fn"]),
                                                   getattr(ct, k["plain"]), captures[k["name"]].calls)
            print(f"{k['name']}: {len(captures[k['name']].calls)} calls equal the plain version")
        # (f)'s dz is (d)'s on the taps (c) saves, at every call of the step
        for (y, sc, sh, g, s), dz in captures["bn_pool_bwd_recompute"].calls:
            taps = ct.bn_pool_fwd_cuda(y, sc, sh, s)[1]
            check(torch.equal(dz, ct.bn_pool_bwd_cuda(y, sc, sh, taps, g, s)),
                  f"bn_pool_bwd_recompute {tuple(y.shape)}: dz differs from (d)'s on (c)'s taps")
        print("bn_pool_bwd_recompute: every call equal to (d) on (c)'s taps")
    gen = torch.Generator(dev).manual_seed(SEED)
    shape = (BATCH, PROJ_H, PROJ_W)
    for stage in ptmodel.rgb_encoder.stages[:2]:
        blocks = [(c.weight, c.bias, b.weight, b.bias) for c, b in stage.blocks]
        cin = stage.blocks[0][0].in_channels
        x = torch.randn(*shape, cin, generator=gen, device=dev).to(torch.bfloat16)
        hw = (shape[1] // 4, shape[2] // 4)
        g = torch.randn(BATCH, *hw, stage.blocks[-1][0].out_channels, generator=gen,
                        device=dev).to(torch.bfloat16)
        runs = {}
        for bwd in ("pallas", "idx"):
            os.environ["I2PNET_POOL_BWD"] = bwd
            leaves = [[t.detach().clone().requires_grad_() for t in blk] for blk in blocks]
            # the first stage's 3 input channels take no dx (the image needs none)
            xg = x.clone().requires_grad_(cin % 8 == 0)
            out_s, _ = ct.fused_stage_train(xg, leaves, stage.strides)
            out_s.backward(g)
            runs[bwd] = [out_s, xg.grad] + [t.grad for blk in leaves for t in blk]
        check(all((a is None and b is None) or torch.equal(a, b)
                  for a, b in zip(runs["pallas"], runs["idx"])),
              f"fused_stage_train at {tuple(x.shape)}: pallas and idx differ")
        print(f"fused_stage_train at {tuple(x.shape)}: out, "
              f"{'dx, ' if cin % 8 == 0 else ''}dw, db, dgamma, dbeta bit-identical under pallas "
              f"and idx")
        shape = (BATCH, *hw)
    del os.environ["I2PNET_POOL_BWD"]

    # --- phase 13: a train-mode proj forward that takes no gradient
    with torch.no_grad():
        out = launches_of("proj_train_nograd", PROJ_NOGRAD_LAUNCHES,
                          lambda: ptmodel(prgb, plidar, praw, pk, generator=pgen))
    check(bool(torch.isfinite(out["out3"]).all()), "no-grad train-mode proj forward: out3")
    print("a train-mode proj forward without gradient: the no-tap forward in every block")

    # --- phase 14: the native chain (I2PNET_FUSED_TRAIN=0) with the routed
    # pool backward (I2PNET_POOL_PALLAS=1)
    os.environ.update(I2PNET_FUSED_TRAIN="0", I2PNET_POOL_PALLAS="1")
    route_capture = Capture(pool_route_cuda, "pool_route_cuda")
    with route_capture:
        m = launches_of("proj_train_native_routed", PROJ_ROUTED_LAUNCHES,
                        lambda: pstep(pstate, pbatch, pgen))
    check(bool(torch.isfinite(m["loss"])), f"native-chain proj loss {float(m['loss'])}")
    for key in ("I2PNET_FUSED_TRAIN", "I2PNET_POOL_PALLAS"):
        del os.environ[key]
    route_calls = {k["name"]: [c for c in route_capture.calls if c[0][2] == int(k["name"][-1])]
                   for k in route_kernels}
    with torch.no_grad():
        for k in route_kernels:
            errors[k["name"]] = train_kernel_error(k["name"], pool_route_cuda.pool_route_cuda,
                                                   pool_route_cuda.pool_route_plain,
                                                   route_calls[k["name"]])
            print(f"{k['name']}: {len(route_calls[k['name']])} calls equal the plain version")
        for k in pallas_kernels:
            rows.append(kernel_row(k, path_launches["proj_train_pallas"][k["name"]],
                                   errors[k["name"]], captures[k["name"]].calls, card))
        for k in route_kernels:
            rows.append(kernel_row(k, path_launches["proj_train_native_routed"][k["name"]],
                                   errors[k["name"]], route_calls[k["name"]], card))
    # --- phase 15: shapes past the kernels' former limits
    past_limits(launches_of, fps_cuda, select_cuda, dev, card)

    # --- phase 16: proj evaluation through the CLI, from a tree on disk
    import shutil
    import tempfile

    import evaluate_torch
    from i2pnet_tpu_torch.data import BatchLoader, KittiLargeRangeDataset, native_io
    from i2pnet_tpu_torch.data.pipeline import prefetch_to_device
    from i2pnet_tpu_torch.eval import Evaluator
    from i2pnet_tpu_torch.train.checkpoint import restore_inference_variables

    del ptmodel, pstate
    t_eval = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    try:
        check(native_io.available(), "the native IO library did not build")
        t0 = time.perf_counter()
        write_large_range_tree(os.path.join(work, "data"))
        print(f"phase 16: wrote the large-range test tree ({2 * EVAL_FRAMES} frames) in "
              f"{time.perf_counter() - t0:.1f} s; native IO library: {native_io._lib_path().name}")
        stages = [init_random_(I2PNetProj(pcfg), torch.Generator().manual_seed(SEED + i)).eval()
                  for i in range(EVAL_STAGES)]
        stage_dirs = save_stages(stages, work)
        argv = ["--root_path", os.path.join(work, "data"), "--model_dir", *stage_dirs,
                "--compute_dtype", "bfloat16", "--batch_size", str(BATCH),
                "--log_dir", os.path.join(work, "cli_eval")]
        with Captures([block, select]) as captures, CascadeRecorder() as rec:
            summary = launches_of("proj_evaluate_cli", CLI_LAUNCHES,
                                  lambda: evaluate_torch.main(argv))
        check_eval_outputs(summary, os.path.join(work, "cli_eval"), 2 * EVAL_FRAMES, "phase 16")
        with torch.no_grad():
            eval_kernel_error("select", select_cuda.selection_multiplicity_plain,
                              captures["select"].calls)
            eval_kernel_error("encoder_block", conv_cuda.conv_block_plain,
                              captures["encoder_block"].calls)
        del captures
        ds = KittiLargeRangeDataset(os.path.join(work, "data"), mode="test", seed=0)
        t0 = time.perf_counter()
        first = collate_first(ds)
        load_ms = (time.perf_counter() - t0) * 1e3 / BATCH
        first = next(prefetch_to_device([first], dev))
        for m, d in zip(stages, stage_dirs):
            m.load_state_dict(restore_inference_variables(d, m), strict=True)
        check_cascade(stages, first, True, rec.outs[0], "phase 16")
        print(f"phase 16: evaluate_torch.py, a {EVAL_STAGES}-stage proj cascade in bf16 at "
              f"B={BATCH}: mean_time_s {summary['mean_time_s']:.6f}, mean_fps "
              f"{summary['mean_fps']:.2f} pairs/s (eager; loading outside the window; the "
              f"checks' captures on); the host loads a sample in {load_ms:.1f} ms (one "
              f"thread) on {card}")
        del first, rec
        evaluator_throughput(
            launches_of, "proj_evaluator_timed", TIMED_CLI_LAUNCHES, stages, pcfg, True,
            Repeated(KittiLargeRangeDataset(os.path.join(work, "data"), mode="test", seed=0),
                     CLI_REPEATS), os.path.join(work, "proj_timed"))
        del stages

        # --- phase 17: free-point evaluation through the Evaluator
        ds = FreeEvalDataset(FREE_EVAL_BATCHES * BATCH, cfg.lidar_in_points)
        stages = [init_random_(I2PNet(cfg), torch.Generator().manual_seed(SEED + i)).eval()
                  for i in range(EVAL_STAGES)]
        stage_dirs = save_stages(stages, os.path.join(work, "free"))
        models = []
        for d in stage_dirs:
            m = I2PNet(cfg)
            m.load_state_dict(restore_inference_variables(d, m), strict=True)
            models.append(m)
        evaluator = Evaluator(models, cfg, proj=False, log_dir=os.path.join(work, "free_eval"))
        with Captures(eval_kernels) as captures, CascadeRecorder() as rec:
            summary = launches_of("free_evaluator", FREE_EVALUATOR_LAUNCHES,
                                  lambda: evaluator.validate(
                                      BatchLoader(ds, BATCH, shuffle=False, drop_last=False)))
        check_eval_outputs(summary, os.path.join(work, "free_eval"), len(ds), "phase 17")
        with torch.no_grad():
            for k in eval_kernels:
                eval_kernel_error(k["name"], getattr(k["module"], k["plain"]),
                                  captures[k["name"]].calls)
        del captures
        first = next(prefetch_to_device([collate_first(ds)], dev))
        check_cascade(models, first, False, rec.outs[0], "phase 17")
        print(f"phase 17: Evaluator, a {EVAL_STAGES}-stage free-point cascade in bf16 at "
              f"B={BATCH}: mean_time_s {summary['mean_time_s']:.6f}, mean_fps "
              f"{summary['mean_fps']:.2f} pairs/s (eager; loading outside the window; the "
              f"checks' captures on) on {card}")
        del evaluator, first, rec
        evaluator_throughput(launches_of, "free_evaluator_timed", TIMED_FREE_LAUNCHES, models,
                             cfg, False, Repeated(ds, FREE_EVAL_REPEATS),
                             os.path.join(work, "free_timed"))
        del stages, models, ds
        print(f"phases 16-17: {time.perf_counter() - t_eval:.1f} s")

        # --- phases 18-20: training through the entry points
        import types

        ctx = types.SimpleNamespace(
            launches_of=launches_of, read_counts=read_counts, train_kernels=train_kernels,
            fps=eval_kernels[0], block=block, cv1=eval_kernels[2], select=select, card=card,
            dev=dev)
        t0 = time.perf_counter()
        proj_training_cli(ctx, work, os.path.join(work, "data"))
        print(f"phase 18: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        free_training(ctx, cfg, work)
        accum_of_one_is_plain(ctx, pcfg, pbatch)
        print(f"phase 19: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    convergence(ctx)
    print(f"phase 20: {time.perf_counter() - t0:.1f} s")

    # --- phases 21-23: efgh, projection masks, the option grid
    ctx.eval_kernels = eval_kernels
    work = tempfile.mkdtemp(prefix="chip_smoke_branches_")
    try:
        t0 = time.perf_counter()
        efgh_errors = efgh_phase(ctx, work)
        print(f"phase 21: {time.perf_counter() - t0:.1f} s on {card}")
        for label, fn in (("22", lambda: mask_phase(ctx, inputs, work)),
                          ("23", lambda: option_grid(ctx, inputs))):
            t0 = time.perf_counter()
            fn()
            print(f"phase {label}: {time.perf_counter() - t0:.1f} s on {card}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for row in rows:  # the efgh path's worst error beside the bench inputs'
        if row["name"] in efgh_errors:
            row["efgh_max_abs_err"] = efgh_errors[row["name"]]

    # --- phases 24-26: the vehicle-localisation protocols, from trees on disk
    ctx.path_launches = path_launches
    work = tempfile.mkdtemp(prefix="chip_smoke_localisation_")
    timed = {}
    try:
        t_loc = time.perf_counter()
        t0 = time.perf_counter()
        parts = [cmr_phase(ctx, work)]
        print(f"phase 24: {time.perf_counter() - t0:.1f} s on {card}")
        t0 = time.perf_counter()
        part, frames = nus_large_phase(ctx, work)
        parts.append(part)
        print(f"phase 25: {time.perf_counter() - t0:.1f} s on {card}")
        t0 = time.perf_counter()
        parts.append(nus_cmr_phase(ctx, work, frames))
        print(f"phase 26: {time.perf_counter() - t0:.1f} s on {card}")
        print(f"phases 24-26: {time.perf_counter() - t_loc:.1f} s on {card}")

        # --- phases 27-29: the reference-checkpoint bridge and --vis_rate,
        # the demo renderers at B=1, the offline builders
        t_user = time.perf_counter()
        t0 = time.perf_counter()
        part, state = bridge_phase(ctx, work)
        parts.append(part)
        print(f"phase 27: {time.perf_counter() - t0:.1f} s on {card}")
        t0 = time.perf_counter()
        parts.append(demo_phase(ctx, work, state))
        print(f"phase 28: {time.perf_counter() - t0:.1f} s on {card}")
        t0 = time.perf_counter()
        builders_phase(ctx, work)
        print(f"phase 29: {time.perf_counter() - t0:.1f} s on {card}")
        print(f"phases 27-29: {time.perf_counter() - t_user:.1f} s on {card}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for part in parts:
        merge_rows(timed, part)
    for row in rows:  # each kernel's calls on the new paths, timed as the row is
        if row["name"] in timed:
            row["new_paths"] = timed[row["name"]]

    # --- phase 30: data parallelism, two ranks on the one card
    work = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        dp_phase(ctx, work, path_launches)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # --- phase 31: the serving export; phase 32: the protocol rehearsal
    work = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    try:
        t0 = time.perf_counter()
        export_phase(ctx, work, path_launches)
        print(f"phase 31: {time.perf_counter() - t0:.1f} s on {card}")
        t0 = time.perf_counter()
        rehearsal_phase(ctx, work)
        print(f"phase 32: {time.perf_counter() - t0:.1f} s on {card}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # --- phase 33: the code that no model path runs, at full width
    t0 = time.perf_counter()
    code_no_model_runs_phase(ctx, path_launches)
    print(f"phase 33: {time.perf_counter() - t0:.1f} s on {card}")

    # --- phase 34: the dense eval level kernel beside its plain chain
    t0 = time.perf_counter()
    dense_level_phase(ctx)
    print(f"phase 34: {time.perf_counter() - t0:.1f} s on {card}")

    for row in rows:
        row["launches_by_path"] = {path: c[row["name"]] for path, c in path_launches.items()}
    print(json.dumps({"kernels": rows}))
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s, the build "
          f"included")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
