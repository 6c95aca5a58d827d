"""Train state and optimizer (port of ``i2pnet_tpu/train/state.py``).

The JAX package's recipe: Adam (lr 1e-3) with weight decay 1e-4 as coupled
L2, the learning rate decayed by 0.99 per epoch as a staircase, optional
global-norm clipping. The model holds the parameters and the BatchNorm
running statistics; the state holds the model, the optimizer, the schedule
and the update count.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


def make_optimizer(params, lr: float = 1e-3, weight_decay: float = 1e-4, lr_decay: float = 0.99,
                   steps_per_epoch: int = 1):
    """(``torch.optim.Adam``, its ``LambdaLR``) as the JAX package's optax
    chain: Adam's ``weight_decay`` adds ``wd * p`` to the gradient before
    the moments, which is ``optax.add_decayed_weights`` placed before
    ``optax.adam`` (coupled L2, not AdamW); the schedule gives update k the
    rate ``lr * lr_decay ** (k // steps_per_epoch)``, what optax's
    ``exponential_decay(staircase=True)`` evaluates."""
    optimizer = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda k: lr_decay ** (k // steps_per_epoch))
    return optimizer, scheduler


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` on the ``.grad`` of ``params``, in
    place: ``g / ||g|| * max_norm`` when ``||g|| >= max_norm``, with no
    epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6). Decided on the
    device: no host synchronisation."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer and
    schedule, the clipping norm (<= 0: off) and the number of updates."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    clip: float = -1.0
    step: int = 0

    def set_step(self, step: int) -> None:
        """Continue from update ``step``: the count and the schedule's rate."""
        self.step = step
        self.scheduler.last_epoch = step
        lrs = [base * fn(step) for base, fn in zip(self.scheduler.base_lrs,
                                                    self.scheduler.lr_lambdas)]
        for group, lr in zip(self.optimizer.param_groups, lrs):
            group["lr"] = lr
        self.scheduler._last_lr = lrs


def create_train_state(model: nn.Module, lr: float = 1e-3, weight_decay: float = 1e-4,
                       lr_decay: float = 0.99, steps_per_epoch: int = 1,
                       clip: float = -1.0) -> TrainState:
    """A fresh state over the model's parameters, on the model's device."""
    optimizer, scheduler = make_optimizer(model.parameters(), lr, weight_decay, lr_decay,
                                          steps_per_epoch)
    return TrainState(model, optimizer, scheduler, clip)
