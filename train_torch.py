#!/usr/bin/env python
"""Training CLI of the PyTorch / CUDA port: the twin of ``train.py``, with
the same flags and defaults and ``--device``.

Builds the model (``i2pnet_tpu_torch/cli.py`` ``build``) and the datasets
(``build_datasets``) of every ``train.py`` protocol: the KITTI odometry
small-range training sequences (``--dataset kd_cmr_snr``, the default;
h5 local maps), the KITTI large-range training and validation splits
(``kd_corr_nolidar``), the raw online-calibration training drives
(``kitti``; ``--efgh`` threads each sample's calibration matrix through the
model), and nuScenes small- and large-range (``nus_cmr_snr``,
``nus_corr_nolidar``: ``train_dataset*.list`` under --root_path; h5 maps,
JPEG frames). Only kd_corr_nolidar has a validation split. Then runs the port's
``Trainer`` (``--train_target class`` trains the mask heads alone): per-epoch
checkpoints with the optimizer state under ``<log_dir>/torch/``, validation
and named best snapshots, config.json, metrics.jsonl and the text logs.
``--resume`` continues from the newest epoch checkpoint, also one that
``tools/jax_ckpt_to_torch.py`` converted from a JAX run. Runs on the CUDA
card unless ``--device cpu`` is given. Under ``torchrun --nproc_per_node N``
it trains data-parallel on N cards (one process each, NCCL; gloo for
``--device cpu``): each rank loads its slice of every --batch_size global
batch, the normalisations take the global batch's statistics, and rank 0
alone writes.

    python3 train_torch.py --root_path /dataset --log_dir log/cmr
    torchrun --nproc_per_node 4 train_torch.py --dataset kd_corr_nolidar \
        --network i2pnet_proj --compute_dtype bfloat16 --batch_size 32 --log_dir log/dp
    python3 train_torch.py --dataset kd_corr_nolidar --network i2pnet_proj \\
        --compute_dtype bfloat16 --num_workers 4 --log_dir log/proj
    python3 train_torch.py --dataset kitti --efgh --compute_dtype bfloat16 \\
        --root_path /dataset/kitti/raw --log_dir log/efgh
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="kd_cmr_snr",
                   choices=["kitti", "kd_cmr_snr", "nus_cmr_snr",
                            "kd_corr_nolidar", "nus_corr_nolidar"],
                   help="the protocol's training split (its loader reads h5 maps for "
                        "kd_cmr_snr and nuScenes, PNGs through cv2 for kitti, JPEGs through "
                        "PIL for nuScenes)")
    p.add_argument("--network", default="i2pnet",
                   choices=["i2pnet", "i2pnet_proj", "i2pnet_proj_iter"])
    p.add_argument("--root_path", default="/dataset")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--max_epoch", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--save_rate", type=int, default=20)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--clip", type=float, default=-1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient-accumulation microbatches per optimizer step")
    p.add_argument("--tiny", action="store_true", help="tiny config (smoke testing)")
    p.add_argument("--debug_nans", action="store_true",
                   help="raise FloatingPointError on the first step whose loss or updated "
                        "parameters are not finite (one host synchronisation a step)")
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"],
                   help="conv/dense compute dtype (params stay f32)")
    p.add_argument("--color_augment", action="store_true",
                   help="image color jitter on the training split")
    p.add_argument("--num_workers", type=int, default=0,
                   help="batch-assembly worker processes (0 = one thread)")
    p.add_argument("--train_target", default="all", choices=["all", "regist", "class"],
                   help="loss composition: registration+mask, registration only, or "
                        "mask-classification only")
    p.add_argument("--efgh", action="store_true",
                   help="online-calibration EFGH variant: thread a per-sample projection "
                        "matrix (data['calib']) through the free-point model (--dataset "
                        "kitti only)")
    p.add_argument("--device", default="cuda",
                   help="the device the model trains on (cuda, or cpu)")
    return p.parse_args(argv)


def main(argv=None):
    """Train; returns the ``Trainer``."""
    args = parse_args(argv)

    import torch.distributed as dist

    from i2pnet_tpu_torch import cli
    from i2pnet_tpu_torch.parallel import maybe_initialize_distributed
    from i2pnet_tpu_torch.train.trainer import Trainer
    from i2pnet_tpu_torch.utils.seeding import set_seed

    # torchrun's environment: one rank a card (no-op in a single process)
    started = not dist.is_initialized() and maybe_initialize_distributed(device=args.device)
    try:
        set_seed(args.seed)
        model, cfg, proj = cli.build(args)
        train_ds, valid_ds = cli.build_datasets(args, cfg)
        trainer = Trainer(
            model, cfg, train_ds, valid_ds,
            log_dir=args.log_dir, batch_size=args.batch_size, lr=args.lr,
            weight_decay=args.weight_decay, clip=args.clip, epochs=args.max_epoch,
            seed=args.seed, proj=proj, save_rate=args.save_rate, resume=args.resume,
            accum_steps=args.accum_steps, run_flags=vars(args), train_target=args.train_target,
            num_workers=args.num_workers, device=args.device, debug_nans=args.debug_nans,
        )
        trainer.train()
    finally:
        if started:
            dist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
