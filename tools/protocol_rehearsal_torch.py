#!/usr/bin/env python
"""Full-protocol rehearsal of the PyTorch port: synthetic data ->
train_torch.py -> checkpoint -> evaluate_torch.py --analyze ->
prediction.txt + metrics npz -> analysis (the twin of
``tools/protocol_rehearsal.py``).

The data is geometrically consistent: each image is the depth-shaded splat
of the frame's point cloud through the on-disk calib at the ground-truth
pose, so the evaluation's RTE/RRE fall below the identity prediction's
(the initial decalibration) only if the whole train -> checkpoint -> eval
chain works. The trees use the protocols' real layouts:

  * kd_cmr_snr:       kitti_processed_CMRNet/sequences/%02d/{local_maps/*.h5,
                      image_2_npy/*.npy, calib.txt} (needs h5py)
  * kd_corr_nolidar:  kitti_processed_DeepI2P/data_odometry_velodyne/sequences/
                      %02d/{voxel0.1-SNr0.6/*.npy, image_2_npy, calib.txt}

The same seed writes the same trees as the JAX tool, file for file.

Usage (the card; without h5py run --families proj):
  python tools/protocol_rehearsal_torch.py --workdir /tmp/rehearsal_torch \\
      [--families cmr,proj] [--max_epoch 20] [--frames 120] [--device cuda|cpu]
Prints one JSON line a stage and family; the "evaluated" line carries the
protocol metrics, and a "protocol" line the model's and the identity
prediction's RTE/RRE over the test split.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# fx=fy=700, cx=600, cy=180 fits the raw 376x1241 KITTI image; Tr is the
# canonical velo (x forward) -> cam (z forward) axis permutation with a
# small offset
CALIB_TXT = """P0: 700.0 0.0 600.0 0.0 0.0 700.0 180.0 0.0 0.0 0.0 1.0 0.0
P2: 700.0 0.0 600.0 44.8 0.0 700.0 180.0 0.2 0.0 0.0 1.0 0.003
Tr: 0.0 -1.0 0.0 0.01 0.0 0.0 -1.0 -0.05 1.0 0.0 0.0 -0.3
"""
IMG_H_RAW, IMG_W_RAW = 376, 1241
CROP_TOP = 50


def _calib_mats(tmp):
    """(K, Pc4): the intrinsic and the velo -> camera projection, as the
    loaders parse calib.txt."""
    from i2pnet_tpu_torch.data.calib import read_calib

    path = os.path.join(tmp, "_calib.txt")
    with open(path, "w") as f:
        f.write(CALIB_TXT)
    Tr, K, P = read_calib(path)
    Tr4 = np.vstack([Tr, [0, 0, 0, 1]])
    Pc4 = P @ Tr4
    return K.astype(np.float64), Pc4.astype(np.float64)


def make_frame(rng, K, Pc4, n_points, z_range=(4.0, 45.0)):
    """One consistent (velo-frame cloud (3, N) f32, full-resolution uint8
    image) pair: points drawn uniformly in pixel space below the crop row
    and in depth, the image their depth-shaded splat."""
    u = rng.uniform(2, IMG_W_RAW - 2, n_points)
    v = rng.uniform(CROP_TOP + 4, IMG_H_RAW - 2, n_points)
    z = rng.uniform(*z_range, n_points)
    pix = np.stack([u * z, v * z, z], axis=0)
    p_cam = np.linalg.solve(K, pix)
    p_h = np.vstack([p_cam, np.ones((1, n_points))])
    p_disk = np.linalg.solve(Pc4, p_h)[:3]

    img = np.zeros((IMG_H_RAW, IMG_W_RAW, 3), np.uint8)
    # at least 8, so that the farthest splat is a lit pixel too
    shade = np.clip(
        255.0 * (1.0 - (z - z_range[0]) / (z_range[1] - z_range[0])), 8, 255
    ).astype(np.uint8)
    # rounded to nearest, as the reprojection K @ p / z lands
    ui, vi = np.rint(u).astype(np.int64), np.rint(v).astype(np.int64)
    img[vi, ui] = shade[:, None]
    return p_disk.astype(np.float32), img


def gen_cmr_root(root, rng, frames_train=120, frames_test=32, n_points=10000):
    """The kd_cmr_snr tree (h5 local maps): training sequences 03 and 05,
    test sequence 00."""
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError("the cmr family writes h5 local maps and needs h5py; "
                           "run --families proj without it") from e

    K, Pc4 = _calib_mats(root)
    for seq, n_frames in ((3, frames_train), (5, frames_train), (0, frames_test)):
        seq_dir = os.path.join(root, "kitti_processed_CMRNet", "sequences", "%02d" % seq)
        os.makedirs(os.path.join(seq_dir, "local_maps"), exist_ok=True)
        os.makedirs(os.path.join(seq_dir, "image_2_npy"), exist_ok=True)
        with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
            f.write(CALIB_TXT)
        for fi in range(n_frames):
            pc, img = make_frame(rng, K, Pc4, n_points)
            with h5py.File(os.path.join(seq_dir, "local_maps", "%06d.h5" % fi), "w") as hf:
                hf["PC"] = np.vstack([pc, np.ones((1, pc.shape[1]), np.float32)])
                hf["intensity"] = rng.uniform(0, 1, (1, pc.shape[1])).astype(np.float32)
            np.save(os.path.join(seq_dir, "image_2_npy", "%06d.npy" % fi), img)
    return root


def gen_large_root(root, rng, frames_train=60, frames_eval=12, n_points=40000):
    """The kd_corr_nolidar tree: training sequences 0-1, test 7-8, and the
    validation sequence 9 that train_torch.py builds."""
    K, Pc4 = _calib_mats(root)
    plan = ((0, frames_train), (1, frames_train), (7, frames_eval), (8, frames_eval),
            (9, frames_eval))
    for seq, n_frames in plan:
        seq_dir = os.path.join(root, "kitti_processed_DeepI2P", "data_odometry_velodyne",
                               "sequences", "%02d" % seq)
        os.makedirs(os.path.join(seq_dir, "voxel0.1-SNr0.6"), exist_ok=True)
        os.makedirs(os.path.join(seq_dir, "image_2_npy"), exist_ok=True)
        with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
            f.write(CALIB_TXT)
        for fi in range(n_frames):
            pc, img = make_frame(rng, K, Pc4, n_points)
            sn = rng.normal(size=(3, n_points)).astype(np.float32)
            sn /= np.linalg.norm(sn, axis=0, keepdims=True) + 1e-9
            data = np.vstack([
                pc,
                rng.uniform(0, 1, (1, n_points)).astype(np.float32),
                sn,
            ]).astype(np.float32)
            np.save(os.path.join(seq_dir, "voxel0.1-SNr0.6", "%06d.npy" % fi), data)
            np.save(os.path.join(seq_dir, "image_2_npy", "%06d.npy" % fi), img)
    return root


def _run(script, argv, log_path, timeout=7200):
    """Run one of the port's CLIs in a child process, its output appended to
    log_path; SystemExit with the log's tail if it fails."""
    cmd = [sys.executable, "-u", os.path.join(REPO, script)] + argv
    with open(log_path, "a") as lf:
        lf.write("\n$ " + " ".join(cmd) + "\n")
        lf.flush()
        rc = subprocess.run(cmd, stdout=lf, stderr=subprocess.STDOUT, timeout=timeout,
                            cwd=REPO).returncode
    if rc != 0:
        with open(log_path) as f:
            tail = f.read()[-3000:]
        raise SystemExit(f"{script} failed rc={rc}\n{tail}")


def _summarize(info_dir):
    """Protocol metrics from the evaluation's files: the mean of each 1-D
    float array of the last metrics npz, and the count of prediction.txt's
    pairs."""
    out = {}
    npzs = [f for f in sorted(os.listdir(info_dir)) if f.endswith(".npz")]
    if npzs:
        z = np.load(os.path.join(info_dir, npzs[-1]))
        for k in z.files:
            a = np.asarray(z[k])
            if a.ndim == 1 and a.size and a.dtype.kind == "f":
                out[f"mean_{k}"] = round(float(np.mean(a)), 3)
    pred = os.path.join(info_dir, "prediction.txt")
    if os.path.exists(pred):
        from i2pnet_tpu_torch.eval.analysis import parse_prediction_file

        mats = parse_prediction_file(pred)
        out["n_eval"] = int(mats["pred"].shape[0])
    return out


def protocol_summary(info_dir):
    """The model's RTE (m) and RRE (deg) over every test pair from
    prediction.txt, the recall at (10 deg, 5 m) from the metrics npz, and
    the identity prediction's RTE/RRE on the same pairs (its extrinsic is
    the initial one: the decalibration the model corrects)."""
    from i2pnet_tpu_torch import metrics as M
    from i2pnet_tpu_torch.eval.analysis import parse_prediction_file, recall_analysis

    mats = parse_prediction_file(os.path.join(info_dir, "prediction.txt"))
    out = {}
    for name, E in (("model", mats["pred"]), ("identity", mats["init"])):
        rre, rte = M.rte_rre(E, mats["gt"])
        out[name] = {"rte_mean": float(rte.mean()), "rte_median": float(np.median(rte)),
                     "rre_mean": float(rre.mean()), "rre_median": float(np.median(rre)),
                     "recall": float(np.mean((rre < 10.0) & (rte < 5.0)))}
    npzs = [f for f in sorted(os.listdir(info_dir)) if f.endswith(".npz")]
    out["model"]["npz_recall"] = recall_analysis(os.path.join(info_dir, npzs[-1]))["recall"]
    out["n_eval"] = int(mats["pred"].shape[0])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="/tmp/rehearsal_torch")
    ap.add_argument("--families", default="cmr,proj")
    ap.add_argument("--max_epoch", type=int, default=20)
    ap.add_argument("--frames", type=int, default=120, help="train frames per sequence")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip_gen", action="store_true",
                    help="reuse an existing --workdir dataset")
    ap.add_argument("--device", default="cuda", help="the CLIs' device: cuda or cpu")
    args = ap.parse_args(argv)

    os.makedirs(args.workdir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    summaries = {}
    for fam in args.families.split(","):
        fam_dir = os.path.join(args.workdir, fam)
        data, log_dir = os.path.join(fam_dir, "data"), os.path.join(fam_dir, "log")
        info = os.path.join(fam_dir, "info_test")
        log_path = os.path.join(fam_dir, "run.log")
        os.makedirs(fam_dir, exist_ok=True)
        if not args.skip_gen:
            os.makedirs(data, exist_ok=True)
            if fam == "cmr":
                gen_cmr_root(data, rng, frames_train=args.frames,
                             frames_test=max(4, args.frames // 4))
            else:
                gen_large_root(data, rng, frames_train=args.frames // 2,
                               frames_eval=max(4, args.frames // 10))
            print(json.dumps({"family": fam, "stage": "generated", "root": data}), flush=True)

        ds, net = (("kd_cmr_snr", "i2pnet") if fam == "cmr"
                   else ("kd_corr_nolidar", "i2pnet_proj"))
        _run("train_torch.py", [
            "--dataset", ds, "--network", net, "--root_path", data,
            "--log_dir", log_dir, "--max_epoch", str(args.max_epoch),
            "--batch_size", str(args.batch_size), "--save_rate",
            str(max(1, args.max_epoch // 2)), "--seed", str(args.seed),
            "--device", args.device,
        ], log_path)
        print(json.dumps({"family": fam, "stage": "trained", "log": log_dir}), flush=True)

        # the cmr family evaluates the reference's two-stage cascade
        model_dirs = [log_dir, log_dir] if fam == "cmr" else [log_dir]
        _run("evaluate_torch.py", [
            "--dataset", ds, "--network", net, "--root_path", data,
            "--model_dir", *model_dirs, "--log_dir", info,
            "--batch_size", str(args.batch_size), "--analyze", "--device", args.device,
        ], log_path)
        summary = {"family": fam, "stage": "evaluated", **_summarize(info)}
        print(json.dumps(summary), flush=True)
        protocol = protocol_summary(info)
        print(json.dumps({"family": fam, "stage": "protocol", **protocol}), flush=True)
        summaries[fam] = {**summary, "protocol": protocol}
    return summaries


if __name__ == "__main__":
    main()
