"""The model factory the port's CLIs share (the port of ``train.py``'s
``build``, without its datasets)."""

from __future__ import annotations

import dataclasses


def build(args):
    """-> (model, cfg, proj) for ``args.network`` (``i2pnet``,
    ``i2pnet_proj``, or ``i2pnet_proj_iter``: the proj config with
    ``refine_iters=6``), with ``args.tiny`` (the tiny config),
    ``args.compute_dtype``, ``args.dataset`` (nuScenes takes the nuScenes
    proj config) and ``args.device`` (the card unless given; ``"cpu"`` for
    the CPU). The model is built on that device with fresh weights."""
    from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
    from i2pnet_tpu_torch.models import I2PNet, I2PNetProj

    device = getattr(args, "device", None)
    proj = args.network.startswith("i2pnet_proj")
    if proj:
        cfg = I2PNetProjConfig.tiny() if args.tiny else I2PNetProjConfig()
        if args.dataset.startswith("nus") and not args.tiny:
            cfg = I2PNetProjConfig.nuscenes()
        if args.network == "i2pnet_proj_iter":
            cfg = dataclasses.replace(cfg, refine_iters=6)
        cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)
        return I2PNetProj(cfg, device=device), cfg, proj
    if getattr(args, "efgh", False):
        raise NotImplementedError("the efgh branch is not ported yet: ROADMAP queue 1, item 7")
    cfg = I2PNetConfig.tiny() if args.tiny else I2PNetConfig()
    cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)
    return I2PNet(cfg, device=device), cfg, proj
