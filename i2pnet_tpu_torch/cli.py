"""The factories the port's CLIs share: the port of ``train.py``'s
``build``, as ``build`` (the model) and ``build_datasets`` (the training
and validation datasets)."""

from __future__ import annotations

import dataclasses


def build(args):
    """-> (model, cfg, proj) for ``args.network`` (``i2pnet``,
    ``i2pnet_proj``, or ``i2pnet_proj_iter``: the proj config with
    ``refine_iters=6``), with ``args.tiny`` (the tiny config),
    ``args.compute_dtype``, ``args.dataset`` (nuScenes takes the nuScenes
    proj config), ``args.efgh`` (the free-point online-calibration variant;
    ``SystemExit`` with another network or dataset than ``kitti``, as
    ``train.py`` refuses it) and ``args.device`` (the card unless given;
    ``"cpu"`` for the CPU). The model is built on that device with fresh
    weights drawn from ``args.seed`` as the JAX package's models start
    (``init_flax_``)."""
    import torch

    from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
    from i2pnet_tpu_torch.models import I2PNet, I2PNetProj, init_flax_

    device = getattr(args, "device", None)
    proj = args.network.startswith("i2pnet_proj")
    efgh = getattr(args, "efgh", False)
    if efgh and (proj or args.dataset != "kitti"):
        raise SystemExit("--efgh needs the free-point network and --dataset kitti (the "
                         "online-calibration loader is the one that emits data['calib'])")
    if proj:
        cfg = I2PNetProjConfig.tiny() if args.tiny else I2PNetProjConfig()
        if args.dataset.startswith("nus") and not args.tiny:
            cfg = I2PNetProjConfig.nuscenes()
        if args.network == "i2pnet_proj_iter":
            cfg = dataclasses.replace(cfg, refine_iters=6)
        cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)
        model = I2PNetProj(cfg, device=device)
    else:
        cfg = I2PNetConfig.tiny() if args.tiny else I2PNetConfig()
        cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype, efgh=efgh)
        model = I2PNet(cfg, device=device)
    init_flax_(model, torch.Generator().manual_seed(getattr(args, "seed", 0)))
    return model, cfg, proj


def kitti_raw_dataset(args, cfg, split: str):
    """``KittiRawCalibDataset`` of the online-calibration protocol's
    ``split`` ('train' or 'test': fixed decalibrations) under
    ``args.root_path``, as ``train.py``/``evaluate.py`` build it: with
    ``args.tiny`` 64x128 images and the config's point count; 'calib'
    emitted under ``args.efgh``."""
    from i2pnet_tpu_torch.data import KittiRawCalibDataset
    from i2pnet_tpu_torch.data.params import KITTI_ONLINE_CALIB

    pp = dict(KITTI_ONLINE_CALIB[split], base_path=args.root_path)
    sp = {}
    if args.tiny:
        pp.update(resize_w=128, resize_h=64)
        sp = dict(sample_point=getattr(cfg, "lidar_in_points", 2048))
    return KittiRawCalibDataset(
        pp["base_path"], pp["date"], pp["drives"], d_rot=pp["d_rot"], d_trans=pp["d_trans"],
        fixed_decalib=pp["fixed_decalib"], resize_w=pp["resize_w"], resize_h=pp["resize_h"],
        seed=args.seed, emit_calib=getattr(args, "efgh", False), **sp)


def build_datasets(args, cfg):
    """-> (train_ds, valid_ds) for ``args.dataset`` under ``args.root_path``,
    as ``train.py`` builds them, with ``args.seed``, ``args.tiny`` and
    ``args.color_augment`` (the training split only). Ported:
    ``kd_corr_nolidar`` (the KITTI large-range split: training sequences
    0-8, validation 9-10; tiny: 64x128 images, 2048 points) and ``kitti``
    (the raw online-calibration training drives, no validation split). The
    other loaders need h5py, cv2 or PIL (ROADMAP queue 1, item 5)."""
    from i2pnet_tpu_torch.data import KittiLargeRangeDataset

    if args.dataset == "kitti":
        return kitti_raw_dataset(args, cfg, "train"), None
    if args.dataset != "kd_corr_nolidar":
        raise NotImplementedError(
            f"--dataset {args.dataset}: its loader needs h5py, cv2 or PIL and is not ported "
            "(ROADMAP queue 1, item 5)")
    kw = dict(img_H=64, img_W=128, sample_point=2048) if args.tiny else {}
    train_ds = KittiLargeRangeDataset(args.root_path, mode="train", seed=args.seed,
                                      color_augment=getattr(args, "color_augment", False), **kw)
    valid_ds = KittiLargeRangeDataset(args.root_path, mode="val", seed=args.seed, **kw)
    return train_ds, valid_ds
