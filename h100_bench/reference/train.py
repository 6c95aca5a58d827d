"""The reference's training step: the forward in training mode (batch
statistics, the heads' dropout from uniforms drawn by the caller), the
two-level registration loss with the learned weights sx and sq, the
gradients by autograd and Adam with coupled L2 (weight decay added to the
gradient before the moments), written out."""

from __future__ import annotations

from typing import Dict, List

import torch

from .nets import Run, forward


def registration_loss(out3, out4, q_gt, t_gt, sx, sq):
    """1.6 x the coarse level's + 0.8 x the refined level's
    ``l_x * exp(-sx) + sx + l_q * exp(-sq) + sq``; l_q the mean distance of
    the quaternions, l_x the mean absolute translation error."""

    def level(out):
        lq = torch.mean(torch.sqrt(torch.sum((q_gt - out[:, :4]) ** 2, -1) + 1e-10))
        lx = torch.mean(torch.abs(out[:, 4:] - t_gt))
        return lx * torch.exp(-sx) + sx + lq * torch.exp(-sq) + sq

    sx, sq = sx.reshape(()), sq.reshape(())
    return 1.6 * level(out4) + 0.8 * level(out3)


def loss_and_grads(family: str, mc: dict, params: Dict[str, torch.Tensor], batch: dict,
                   dropout: List[torch.Tensor], cast=None, trainable=None):
    """(loss, {name: gradient}) of one step's forward on ``batch`` (model
    keys: rgb, lidar, intrinsic, lidar_feats, raw_xyz, decalib_q_gt,
    decalib_t_gt)."""
    names = trainable or [n for n in params if not n.endswith(("running_mean", "running_var"))]
    leaves = {n: params[n].detach().clone().requires_grad_(n in names) for n in params}
    run = Run(leaves, training=True, cast=cast, dropout=dropout,
              dropout_rate=mc.get("head_dropout_rate", 0.5))
    out3, out4 = forward(family)(run, mc, batch["rgb"], batch["lidar"], batch["intrinsic"],
                                 batch["lidar_feats"], batch["raw_xyz"])
    loss = registration_loss(out3, out4, batch["decalib_q_gt"], batch["decalib_t_gt"],
                             leaves["sx"], leaves["sq"])
    grads = torch.autograd.grad(loss, [leaves[n] for n in names])
    return loss.detach(), dict(zip(names, grads))


class Adam:
    """Adam (betas 0.9, 0.999, eps 1e-8) on a dict of tensors with coupled
    L2: g + wd * p enters the moments; the rate of update k is
    lr * decay ** (k // steps_per_epoch)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr=1e-3, weight_decay=1e-4,
                 lr_decay=0.99, steps_per_epoch=1):
        self.lr, self.wd, self.decay, self.spe = lr, weight_decay, lr_decay, steps_per_epoch
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.k = 0

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        """Update ``params`` in place; returns {name: g + wd * p}, the
        gradient as the moments take it."""
        lr = self.lr * self.decay ** (self.k // self.spe)
        self.k += 1
        bc1, bc2 = 1 - 0.9 ** self.k, 1 - 0.999 ** self.k
        seen = {}
        for n, g in grads.items():
            p = params[n]
            g = g + self.wd * p
            seen[n] = g
            self.m[n].mul_(0.9).add_(g, alpha=0.1)
            self.v[n].mul_(0.999).addcmul_(g, g, value=0.001)
            denom = (self.v[n].sqrt() / bc2 ** 0.5).add_(1e-8)
            p.addcdiv_(self.m[n], denom, value=-lr / bc1)
        return seen
