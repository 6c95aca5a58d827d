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
    proj config) and ``args.device`` (the card unless given; ``"cpu"`` for
    the CPU). The model is built on that device with fresh weights drawn
    from ``args.seed`` as the JAX package's models start (``init_flax_``)."""
    import torch

    from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
    from i2pnet_tpu_torch.models import I2PNet, I2PNetProj, init_flax_

    device = getattr(args, "device", None)
    proj = args.network.startswith("i2pnet_proj")
    if proj:
        cfg = I2PNetProjConfig.tiny() if args.tiny else I2PNetProjConfig()
        if args.dataset.startswith("nus") and not args.tiny:
            cfg = I2PNetProjConfig.nuscenes()
        if args.network == "i2pnet_proj_iter":
            cfg = dataclasses.replace(cfg, refine_iters=6)
        cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)
        model = I2PNetProj(cfg, device=device)
    else:
        if getattr(args, "efgh", False):
            raise NotImplementedError(
                "the efgh branch is not ported yet: ROADMAP queue 1, item 7")
        cfg = I2PNetConfig.tiny() if args.tiny else I2PNetConfig()
        cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)
        model = I2PNet(cfg, device=device)
    init_flax_(model, torch.Generator().manual_seed(getattr(args, "seed", 0)))
    return model, cfg, proj


def build_datasets(args, cfg):
    """-> (train_ds, valid_ds) for ``args.dataset`` under ``args.root_path``,
    as ``train.py`` builds them, with ``args.seed``, ``args.tiny`` (64x128
    images, 2048 points) and ``args.color_augment`` (the training split
    only). Only ``kd_corr_nolidar`` (the KITTI large-range split: training
    sequences 0-8, validation 9-10) is ported; the other loaders need
    h5py, cv2 or PIL (ROADMAP queue 1, item 5)."""
    from i2pnet_tpu_torch.data import KittiLargeRangeDataset

    if args.dataset != "kd_corr_nolidar":
        raise NotImplementedError(
            f"--dataset {args.dataset}: its loader needs h5py, cv2 or PIL and is not ported "
            "(ROADMAP queue 1, item 5)")
    kw = dict(img_H=64, img_W=128, sample_point=2048) if args.tiny else {}
    train_ds = KittiLargeRangeDataset(args.root_path, mode="train", seed=args.seed,
                                      color_augment=getattr(args, "color_augment", False), **kw)
    valid_ds = KittiLargeRangeDataset(args.root_path, mode="val", seed=args.seed, **kw)
    return train_ds, valid_ds
