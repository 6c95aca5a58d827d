#!/usr/bin/env python
"""Evaluation CLI of the PyTorch / CUDA port: the twin of ``evaluate.py``,
with the same flags and defaults and ``--device``.

Loads the stages' checkpoints (a cascade when several --model_dir are
given; each a log dir holding the port's checkpoints under ``torch/``, see
``i2pnet_tpu_torch/train/checkpoint.py``; a JAX run is converted with
``tools/jax_ckpt_to_torch.py``), runs ``--dataset``'s test protocol
(``i2pnet_tpu_torch/cli.py`` ``eval_split``): KITTI large-range
(``kd_corr_nolidar``, the default), KITTI odometry small-range
(``kd_cmr_snr``: sequence 00 under fixed decalibrations, the generated
table of --seed or a ``--test_rt`` CSV or per-seed pickle; the 10-seed
protocol is ``scripts/cmr_test_torch.sh``), online calibration on the raw
test drive (``kitti``, fixed decalibrations; ``--efgh`` for the efgh
model), or nuScenes (``nus_cmr_snr`` with its own --test_rt,
``nus_corr_nolidar``; ``test_dataset*.list`` under --root_path), and writes
log_test.txt, prediction.txt and a metrics npz under --log_dir in the JAX
package's formats; --analyze prints recall stats from the npz; --vis_rate N
logs the init/pred/gt projection overlays of sample 0 of every Nth batch to
a ``UniWriter`` on --log_dir (TensorBoard where tensorboardX is installed).
Runs on the CUDA card unless ``--device cpu`` is given. The reference's
released weights are converted with ``tools/reference_ckpt_to_torch.py``.

    python3 evaluate_torch.py --model_dir runA runB --compute_dtype bfloat16
    python3 evaluate_torch.py --dataset kd_cmr_snr --network i2pnet --model_dir log/cmr \\
        --test_rt test_RT_seq00_10.00_2.00_0.pkl --seed 0 --tag _seed0
"""

from __future__ import annotations

import argparse
import glob
import os
import warnings

# the datasets whose loaders read --test_rt (evaluate.py)
_READS_TEST_RT = ("kd_cmr_snr", "nus_cmr_snr")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="kd_corr_nolidar",
                   choices=["kitti", "kd_cmr_snr", "nus_cmr_snr",
                            "kd_corr_nolidar", "nus_corr_nolidar"],
                   help="the protocol whose test split is evaluated")
    p.add_argument("--network", default="i2pnet_proj",
                   choices=["i2pnet", "i2pnet_proj", "i2pnet_proj_iter"])
    p.add_argument("--root_path", default="/dataset")
    p.add_argument("--model_dir", nargs="+", required=True,
                   help="trainer log dirs; several => cascade")
    p.add_argument("--best", default="model_rotation_best",
                   help="best-snapshot name, or 'latest' for the newest "
                        "epoch checkpoint")
    p.add_argument("--log_dir", default="info_test")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tag", default="")
    p.add_argument("--test_rt", default=None,
                   help="fixed test decalibrations, a CSV (a header such as "
                        "id,tx,ty,tz,rx,ry,rz, or none) or a per-seed pickle, read by "
                        "kd_cmr_snr and nus_cmr_snr; the other datasets take the flag and "
                        "ignore it, as evaluate.py does")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--debug_nans", action="store_true",
                   help="check every stage's out3/out4 with torch.isfinite "
                        "and raise on the first non-finite batch")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--analyze", action="store_true")
    p.add_argument("--vis_rate", type=int, default=0,
                   help="log the projection overlays of sample 0 of every Nth batch "
                        "to a writer on --log_dir; 0 logs none")
    p.add_argument("--efgh", action="store_true",
                   help="online-calibration EFGH variant (kitti dataset, free-point "
                        "network): thread data['calib'] through the forward")
    p.add_argument("--dp", action="store_true",
                   help="data-parallel eval fan-out; not ported (ROADMAP "
                        "queue 1, item 9)")
    p.add_argument("--knn_mode", default="exact", choices=["exact", "approx"],
                   help="level-1 KNN at eval. The port's KNN is always "
                        "exact, and 'approx' runs it too: the JAX package "
                        "approximates it only on the TPU, and off the TPU "
                        "computes the exact KNN as well")
    p.add_argument("--device", default="cuda",
                   help="the device the models run on (cuda, or cpu)")
    return p.parse_args(argv)


def _refuse_unported(args) -> None:
    if args.test_rt and args.dataset not in _READS_TEST_RT:
        warnings.warn(f"--test_rt {args.test_rt}: the {args.dataset} loader does not read it "
                      "(evaluate.py ignores it too)")
    if args.dp:
        raise NotImplementedError("--dp: the data-parallel fan-out is not ported "
                                  "(ROADMAP queue 1, item 9)")


def main(argv=None):
    """Run the protocol; returns the summary dict."""
    args = parse_args(argv)
    _refuse_unported(args)

    from i2pnet_tpu_torch.cli import build, eval_split
    from i2pnet_tpu_torch.data import BatchLoader
    from i2pnet_tpu_torch.eval import Evaluator, recall_analysis
    from i2pnet_tpu_torch.train.checkpoint import restore_inference_variables
    from i2pnet_tpu_torch.utils.monitor import UniWriter
    from i2pnet_tpu_torch.utils.seeding import set_seed

    set_seed(args.seed)
    models = []
    for mdir in args.model_dir:
        model, cfg, proj = build(args)
        model.load_state_dict(restore_inference_variables(mdir, model, best=args.best),
                              strict=True)
        models.append(model)

    # evaluate.py re-seeds the test split's generator after drawing a
    # template sample; the port draws none, so the split starts from the seed
    test_ds = eval_split(args, cfg)
    loader = BatchLoader(test_ds, args.batch_size, shuffle=False, drop_last=False)
    writer = UniWriter(args.log_dir) if args.vis_rate > 0 else None
    evaluator = Evaluator(models, cfg, proj=proj, log_dir=args.log_dir, tag=args.tag,
                          writer=writer, vis_rate=args.vis_rate, device=args.device,
                          debug_nans=args.debug_nans)
    summary = evaluator.validate(loader)
    if writer is not None:
        writer.close()
    print("== evaluation summary ==")
    for k, v in summary.items():
        print(f"  {k}: {v}")

    if args.analyze:
        npzs = sorted(glob.glob(os.path.join(args.log_dir, "metrics_*.npz")))
        if npzs:
            print("== recall analysis ==")
            for k, v in recall_analysis(npzs[-1]).items():
                print(f"  {k}: {v}")
    return summary


if __name__ == "__main__":
    main()
