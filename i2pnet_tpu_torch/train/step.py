"""The train and eval steps of both families (port of
``i2pnet_tpu/train/step.py``).

One step is forward in train mode (batch-statistics BatchNorm, which moves
the running statistics, and head dropout), the loss, backward, optional
global-norm clipping, Adam with coupled L2, and the schedule. Everything
stays on the model's device: the metrics are device tensors and the step
makes no host synchronisation. An eval step is the model's eval forward
under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
from i2pnet_tpu_torch.losses import get_projection_gt, projection_mask_loss, registration_loss
from i2pnet_tpu_torch.parallel.mesh import ambient_mesh, average_gradients_, average_metrics
from i2pnet_tpu_torch.train.state import TrainState, clip_by_global_norm_
from i2pnet_tpu_torch.utils.trace import span


def _compute_gt_project(batch, hw) -> torch.Tensor:
    """The in-frustum labels of the batch's cloud under its ground-truth
    decalibration, one-hot (B, N, 2) f32, computed on the device."""
    labels = get_projection_gt(batch["lidar"], batch["intrinsic"], tuple(hw),
                               batch["decalib_q_gt"], batch["decalib_t_gt"])
    return F.one_hot(labels.long(), 2).float()


def _delay_now_step(cfg: I2PNetConfig, step: int, device) -> Optional[torch.Tensor]:
    """The delay counter at update ``step``, max(mask_delay_step - step, 0),
    filled on the device; None (the model's fresh counter) unless
    mask_delay or ab_delay is set. The count is the train state's, not a
    module buffer."""
    if not (cfg.mask_delay or cfg.ab_delay):
        return None
    return torch.full((), max(float(cfg.mask_delay_step) - float(step), 0.0), device=device)


def _free_point_loss_fn(model, cfg: I2PNetConfig, img_size=None, train_target: str = "all"):
    """loss(batch, generator=None, step=0) -> (loss, metrics), as
    ``_free_point_loss_fn`` of the JAX package. train_target picks the loss
    composition: 'all' is registration + 1.5 * mask loss, 'regist'
    registration only (the mask loss still logged), 'class' the mask loss
    only; the mask loss weighs l4 by 1.6 and l3 by 0.8 where both heads
    exist. Under ground_truth_projection_mask the batch's gt_project is
    computed on the device when it has none; the delay counter follows the
    update count ``step``."""
    if train_target not in ("all", "regist", "class"):
        raise ValueError(f"train_target must be all|regist|class, got {train_target}")

    def loss_fn(batch, generator=None, step=0):
        hw = img_size or tuple(batch["rgb"].shape[1:3])
        gt_project = batch.get("gt_project")
        if gt_project is None and cfg.ground_truth_projection_mask:
            gt_project = _compute_gt_project(batch, hw)
        out = model(
            batch["rgb"], batch["lidar"], batch["intrinsic"],
            lidar_feature=batch.get("lidar_feats"), raw_xyz=batch.get("raw_xyz"),
            gt_project=gt_project, now_step=_delay_now_step(cfg, step, batch["rgb"].device),
            calib=batch.get("calib"), generator=generator,
        )
        reg_loss, loss_q, loss_x = registration_loss(
            out["out3"], out["out4"], batch["decalib_q_gt"], batch["decalib_t_gt"],
            out["sx"], out["sq"], l1_trans=cfg.l1_trans_loss,
        )
        pl3, pl4 = (
            projection_mask_loss(
                out.get(key), batch["intrinsic"], hw, batch["decalib_q_gt"],
                batch["decalib_t_gt"], focal=cfg.focal_mask_loss, focal_gamma=cfg.focal_gamma,
                sigmoid=cfg.mask_sigmoid,
            )
            for key in ("pm3", "pm4")
        )
        if pl3 is not None and pl4 is not None:
            mask_loss = 1.6 * pl4 + 0.8 * pl3
        else:
            mask_loss = pl4 if pl3 is None else pl3
        if train_target == "class":
            if mask_loss is None:
                raise ValueError("train_target='class' needs mask heads enabled")
            loss = mask_loss
        else:
            loss = reg_loss
            if mask_loss is not None and train_target == "all":
                loss = loss + 1.5 * mask_loss
        metrics = {
            "loss": loss,
            "loss_q": loss_q,
            "loss_x": loss_x,
            "loss_mask": mask_loss if mask_loss is not None else torch.zeros_like(loss),
            # copies: the update changes the parameters in place after this
            "sx": out["sx"].reshape(()).clone(),
            "sq": out["sq"].reshape(()).clone(),
        }
        return loss, {k: v.detach() for k, v in metrics.items()}

    return loss_fn


def _proj_loss_fn(model, cfg: I2PNetProjConfig):
    """loss(batch, generator=None, step=0) -> (loss, metrics), as
    ``_proj_loss_fn`` of the JAX package: the registration loss alone (the
    projection family has no mask or delay branch); the batch also carries
    raw_xyz."""

    def loss_fn(batch, generator=None, step=0):
        del step  # no mask or delay branch
        out = model(batch["rgb"], batch["lidar"], batch["raw_xyz"], batch["intrinsic"],
                    lidar_feature=batch.get("lidar_feats"), generator=generator)
        loss, loss_q, loss_x = registration_loss(
            out["out3"], out["out4"], batch["decalib_q_gt"], batch["decalib_t_gt"],
            out["sx"], out["sq"], l1_trans=cfg.l1_trans_loss,
        )
        metrics = {"loss": loss, "loss_q": loss_q, "loss_x": loss_x,
                   "sx": out["sx"].reshape(()).clone(), "sq": out["sq"].reshape(()).clone()}
        return loss, {k: v.detach() for k, v in metrics.items()}

    return loss_fn


def _make_step(model, loss_fn, accum_steps: int = 1):
    """The train step over ``accum_steps`` microbatches (one for the plain
    step): each runs forward and backward in turn, adding its gradients to
    ``.grad``; their sum is divided by ``accum_steps`` before the clip, then
    Adam makes one update and the schedule one step. With one microbatch
    the slice is the whole batch, the division by 1 and the mean of one
    value are exact, so the plain step is this step bit for bit.

    Under an ambient mesh (``parallel/mesh.py`` ``shard_train_step``) every
    gradient, zero-filled ones included, is averaged over the ranks after
    the loop and before the clip (optax clips the gradient the update
    sees), and so are the metrics. Every loss on a step path is a mean
    over the rank's rows, which are as many on every rank, so the average
    is the global batch's gradient."""

    def train_step(state: TrainState, batch: dict, generator=None) -> dict:
        B = batch["rgb"].shape[0]
        if B % accum_steps != 0:
            raise ValueError(f"batch size {B} not divisible by accum_steps {accum_steps}")
        size = B // accum_steps
        with span("i2pnet/train/step"):
            model.train()
            state.optimizer.zero_grad(set_to_none=True)
            metrics = []
            for i in range(accum_steps):
                with span("i2pnet/train/forward"):
                    loss, m = loss_fn({k: v[i * size:(i + 1) * size] for k, v in batch.items()},
                                      generator, state.step)
                with span("i2pnet/train/backward"):
                    loss.backward()
                metrics.append(m)
            with span("i2pnet/train/optimizer"):
                with torch.no_grad():
                    for p in model.parameters():
                        if p.grad is None:
                            # a parameter the loss does not reach (the pose
                            # heads under 'class', the mask heads under
                            # 'regist'): a zero gradient, which Adam's decay
                            # term still moves, as optax moves it
                            p.grad = torch.zeros_like(p)
                        else:
                            p.grad.div_(accum_steps)
                mesh = ambient_mesh()
                if mesh is not None:
                    average_gradients_(model.parameters(), mesh)
                if state.clip > 0:
                    clip_by_global_norm_(model.parameters(), state.clip)
                state.optimizer.step()
                state.scheduler.step()
            state.step += 1
            out = {k: torch.stack([m[k] for m in metrics]).mean(0) for k in metrics[0]}
            return out if mesh is None else average_metrics(out, mesh)

    return train_step


def make_train_step(model, cfg: I2PNetConfig, img_size: Optional[Tuple[int, int]] = None,
                    train_target: str = "all"):
    """Returns ``train_step(state, batch, generator=None) -> metrics``.

    batch: dict of tensors on the model's device: rgb (B,H,W,3), lidar
    (B,N,3), intrinsic (B,3,3), decalib_q_gt (B,4), decalib_t_gt (B,3);
    optional lidar_feats and raw_xyz (B,N,3), gt_project (B,N,2) and calib
    (B,3or4,4) (the efgh matrix). generator: a
    ``torch.Generator`` on that device for the dropout. ``state`` is a
    ``TrainState`` over ``model``; the step updates it in place.
    """
    return _make_step(model, _free_point_loss_fn(model, cfg, img_size, train_target))


def make_train_step_proj(model, cfg: I2PNetProjConfig):
    """``make_train_step`` for ``I2PNetProj``: the batch also carries raw_xyz
    (B,N,3), the raw cloud that sets the range image."""
    return _make_step(model, _proj_loss_fn(model, cfg))


def make_accum_train_step(model, cfg, accum_steps: int, proj: bool = False,
                          img_size: Optional[Tuple[int, int]] = None, train_target: str = "all"):
    """Gradient accumulation: ``train_step(state, batch, generator=None) ->
    metrics`` with one optimizer update per call, built from ``accum_steps``
    microbatches run forward and backward one after another (the JAX
    package's ``make_accum_train_step``).

    The batch's leading axis B splits into ``accum_steps`` microbatches of
    B // accum_steps samples (B not divisible raises ``ValueError``). The
    gradients are summed over the microbatches and divided by
    ``accum_steps``; clipping applies to that average, then Adam makes one
    update and the schedule one step. BatchNorm running statistics move
    microbatch by microbatch (each normalises with its own statistics). The
    metrics are the microbatches' mean. The dropout generator is drawn
    microbatch after microbatch (JAX splits its key per microbatch, so the
    two agree only with dropout off). With ``accum_steps=1`` the step is
    bit-identical to ``make_train_step`` / ``make_train_step_proj``.
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    loss_fn = (_proj_loss_fn(model, cfg) if proj
               else _free_point_loss_fn(model, cfg, img_size, train_target))
    return _make_step(model, loss_fn, accum_steps)


def make_eval_step_proj(model, cfg: I2PNetProjConfig):
    """Returns ``eval_step(batch) -> out dict`` for ``I2PNetProj``: the model
    in eval mode under ``torch.inference_mode()``. batch: rgb, lidar,
    raw_xyz, intrinsic and optional lidar_feats, tensors on the model's
    device."""

    def eval_step(batch: dict) -> dict:
        model.eval()
        with torch.inference_mode():
            return model(batch["rgb"], batch["lidar"], batch["raw_xyz"], batch["intrinsic"],
                         lidar_feature=batch.get("lidar_feats"))

    return eval_step


def make_eval_step(model, cfg: I2PNetConfig, state: Optional[TrainState] = None):
    """Returns ``eval_step(batch) -> out dict`` for ``I2PNet``: the model in
    eval mode under ``torch.inference_mode()``. batch: rgb, lidar,
    intrinsic and optional lidar_feats, raw_xyz, calib and gt_project,
    tensors on the model's device.

    With ``state``, the step validates as the JAX package's eval step: the
    batch's gt_project (computed on the device under
    ground_truth_projection_mask_eval when it has none) and the delay
    counter at ``state.step``, read at each call. Without it, as the JAX
    package's Evaluator forwards a cascade stage: no gt_project, the fresh
    counter."""

    def eval_step(batch: dict) -> dict:
        gt_project, now_step = None, None
        if state is not None:
            gt_project = batch.get("gt_project")
            if gt_project is None and cfg.ground_truth_projection_mask_eval:
                gt_project = _compute_gt_project(batch, batch["rgb"].shape[1:3])
            now_step = _delay_now_step(cfg, state.step, batch["rgb"].device)
        model.eval()
        with torch.inference_mode():
            return model(batch["rgb"], batch["lidar"], batch["intrinsic"],
                         lidar_feature=batch.get("lidar_feats"), raw_xyz=batch.get("raw_xyz"),
                         gt_project=gt_project, now_step=now_step, calib=batch.get("calib"))

    return eval_step
