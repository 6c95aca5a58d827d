"""The factories the port's CLIs share: the port of ``train.py``'s
``build``, as ``build`` (the model) and ``build_datasets`` (the training
and validation datasets), and of ``evaluate.py``'s test split, as
``eval_split``: every ``--dataset`` of the two CLIs."""

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


def nuscenes_splits(root_path: str, split: str) -> list:
    """The pickled split lists ``<root_path>/<split>_dataset*.list``, sorted,
    as ``train.py`` and ``evaluate.py`` glob them."""
    import glob

    return sorted(glob.glob(f"{root_path}/{split}_dataset*.list"))


def _cmr_tiny(args, cfg) -> dict:
    """--tiny's CMR override: 64x128 images and the config's point count
    (2048 for a proj config, which has none)."""
    if not args.tiny:
        return {}
    return dict(img_H=64, img_W=128, sample_point=getattr(cfg, "lidar_in_points", 2048))


def _large_range_tiny(args) -> dict:
    """--tiny's large-range override: 64x128 images and 2048 points."""
    return dict(img_H=64, img_W=128, sample_point=2048) if args.tiny else {}


def build_datasets(args, cfg):
    """-> (train_ds, valid_ds) for ``args.dataset`` under ``args.root_path``,
    as ``train.py`` builds them, with ``args.seed``, ``args.tiny`` and
    ``args.color_augment`` (the KITTI training splits). ``kd_corr_nolidar``:
    the KITTI large-range split, training sequences 0-8 and validation
    9-10 (tiny: 64x128 images, 2048 points). ``kd_cmr_snr``: the KITTI
    odometry small-range training sequences (tiny: 64x128, the config's
    point count). ``kitti``: the raw online-calibration training drives.
    ``nus_cmr_snr`` and ``nus_corr_nolidar``: the nuScenes loaders over
    ``train_dataset*.list``, which ``--tiny`` leaves at full size. Only
    ``kd_corr_nolidar`` has a validation split; the others return None."""
    from i2pnet_tpu_torch.data import (KittiLargeRangeDataset, KittiOdometryCMRDataset,
                                       NuScenesCMRDataset, NuScenesLargeRangeDataset)

    color = getattr(args, "color_augment", False)
    if args.dataset == "kitti":
        return kitti_raw_dataset(args, cfg, "train"), None
    if args.dataset == "kd_cmr_snr":
        return KittiOdometryCMRDataset(args.root_path, mode="train", seed=args.seed,
                                       color_augment=color, **_cmr_tiny(args, cfg)), None
    if args.dataset == "kd_corr_nolidar":
        kw = _large_range_tiny(args)
        train_ds = KittiLargeRangeDataset(args.root_path, mode="train", seed=args.seed,
                                          color_augment=color, **kw)
        valid_ds = KittiLargeRangeDataset(args.root_path, mode="val", seed=args.seed, **kw)
        return train_ds, valid_ds
    cls = NuScenesCMRDataset if args.dataset == "nus_cmr_snr" else NuScenesLargeRangeDataset
    return cls(args.root_path, nuscenes_splits(args.root_path, "train"), mode="train",
               seed=args.seed), None


def eval_split(args, cfg):
    """``args.dataset``'s test split under ``args.root_path``, as
    ``evaluate.py`` builds it, with ``args.seed`` and ``args.tiny`` (the
    KITTI loaders only; nuScenes stays at full size). ``args.test_rt``, a
    fixed decalibration table (``data/preprocess.py`` ``load_test_rt``: a
    CSV or a per-seed pickle), is read by ``kd_cmr_snr`` (keyed by frame id)
    and ``nus_cmr_snr`` (keyed by index); without it they generate their
    table from the seed. The other loaders draw their decalibrations."""
    from i2pnet_tpu_torch.data import (KittiLargeRangeDataset, KittiOdometryCMRDataset,
                                       NuScenesCMRDataset, NuScenesLargeRangeDataset)
    from i2pnet_tpu_torch.data.preprocess import load_test_rt

    rt = {}
    if getattr(args, "test_rt", None) and args.dataset in ("kd_cmr_snr", "nus_cmr_snr"):
        rt = dict(test_rt=load_test_rt(args.test_rt))
    if args.dataset == "kitti":
        return kitti_raw_dataset(args, cfg, "test")
    if args.dataset == "kd_cmr_snr":
        return KittiOdometryCMRDataset(args.root_path, mode="test", seed=args.seed,
                                       **_cmr_tiny(args, cfg), **rt)
    if args.dataset == "kd_corr_nolidar":
        return KittiLargeRangeDataset(args.root_path, mode="test", seed=args.seed,
                                      **_large_range_tiny(args))
    splits = nuscenes_splits(args.root_path, "test")
    if args.dataset == "nus_cmr_snr":
        return NuScenesCMRDataset(args.root_path, splits, mode="test", seed=args.seed, **rt)
    return NuScenesLargeRangeDataset(args.root_path, splits, mode="test", seed=args.seed)
