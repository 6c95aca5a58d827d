"""Training harness (port of ``i2pnet_tpu/train/trainer.py``).

One object drives the train step over a ``BatchLoader`` (its forked
worker pool with ``num_workers >= 1``), the per-epoch checkpoints with the
optimizer state and resume, validation with RTE/RRE, the per-axis
calibration errors and MSEE, best-model tracking (rotation, translation,
MSEE) with named snapshots, ``UniWriter`` logging and the resolved config
in config.json, with the JAX package's file names and keys.

The model is taken as built and never re-initialised (JAX's trainer
initialises its variables from a sample batch; a port model loads them
with ``convert.load_flax_variables``). Everything runs on ``device``, the
card unless ``"cpu"`` is given. Validation also gives the projection-mask
accuracy ``acc`` of the mask head the JAX trainer reads (0.0 without one);
with ``train_target="class"`` the run trains the mask heads alone and keeps
``model_acc_best`` as its only snapshot.

Under a process group (``torchrun --nproc_per_node N train_torch.py``;
``parallel/distributed.py``) the trainer trains data-parallel, as the JAX
trainer does over its devices: each rank loads its slice of every global
batch, grouped by microbatch (``host_batch_rows``), the ranks start from rank 0's model
(``replicate_``, also after a resume) and run ``shard_train_step`` (global
batch statistics, gradients averaged before the clip), and each rank
draws dropout from its own generator, seeded from (seed, rank). Validation
runs outside the DP context on every rank, over the whole split, as the
JAX trainer's unsharded eval step; only rank 0 writes (the logs,
config.json, the checkpoints and the bests), and the ranks meet at a
barrier after each epoch's checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tarfile
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from i2pnet_tpu_torch import metrics as M
from i2pnet_tpu_torch.data.pipeline import BatchLoader, prefetch_to_device, to_model_batch
from i2pnet_tpu_torch.eval.evaluator import MODEL_KEYS
from i2pnet_tpu_torch.losses import get_projection_gt
from i2pnet_tpu_torch.models.i2pnet import resolve_device
from i2pnet_tpu_torch.parallel import distributed as D
from i2pnet_tpu_torch.parallel.mesh import make_mesh, replicate_, shard_train_step
from i2pnet_tpu_torch.train.checkpoint import CheckpointManager, restore_train_state
from i2pnet_tpu_torch.train.state import create_train_state
from i2pnet_tpu_torch.train.step import make_accum_train_step, make_eval_step, make_eval_step_proj
from i2pnet_tpu_torch.utils.monitor import UniWriter


class Trainer:
    def __init__(
        self,
        model: torch.nn.Module,
        cfg,
        train_dataset,
        valid_dataset=None,
        log_dir: str = "log",
        batch_size: int = 8,
        lr: float = 1e-3,
        weight_decay: float = 1e-4,
        clip: float = -1.0,
        epochs: int = 200,
        seed: int = 0,
        proj: bool = False,
        save_rate: int = 20,
        resume: bool = False,
        accum_steps: int = 1,
        run_flags: Optional[dict] = None,
        train_target: str = "all",
        extra_valid_datasets: Optional[Dict[str, Any]] = None,
        num_workers: int = 0,
        device=None,
        debug_nans: bool = False,
    ):
        """The JAX trainer's arguments, and: ``device``, the model's device
        (the card unless ``"cpu"`` is given; without a card that raises);
        ``debug_nans``, which raises ``FloatingPointError`` on the first
        step whose loss or updated parameters are not finite (one host
        synchronisation a step).

        train_target: 'all' (registration + mask loss), 'regist' or 'class'
        (the mask heads alone).
        extra_valid_datasets: optional {prefix: dataset}, more validation
        splits, each with its own bests and snapshots
        ('{prefix}model_rotation_best', ...)."""
        self.device = resolve_device(device)
        model_device = next(model.parameters()).device
        if model_device.type != self.device.type:
            raise ValueError(f"the model lies on {model_device}, the trainer on {self.device}")
        self.model = model
        self.cfg = cfg
        self.proj = proj
        self.train_target = train_target
        self.epochs = epochs
        self.batch_size = batch_size
        self.save_rate = save_rate
        self.seed = seed
        self.log_dir = log_dir
        self.debug_nans = debug_nans
        # data parallel under a process group; rank 0 alone writes
        self.mesh = make_mesh(self.device) if D.is_initialized() else None
        self.rank, world = D.process_info()
        # every rank's microbatches equal in size (the JAX trainer would drop
        # to fewer devices; a torchrun rank cannot), checked before any write
        if accum_steps >= 1 and batch_size % (accum_steps * world):
            raise ValueError(
                f"the train step needs B % (accum_steps * world) == 0: B {batch_size}, "
                f"accum_steps {accum_steps}, world {world}")
        if self.rank == 0:
            os.makedirs(log_dir, exist_ok=True)

        self.writer = UniWriter(log_dir)
        resolved = {
            "config": dataclasses.asdict(cfg),
            "flags": run_flags or {},
            "batch_size": batch_size,
            "lr": lr,
            "weight_decay": weight_decay,
            "clip": clip,
            "epochs": epochs,
            "seed": seed,
            "proj": proj,
            "accum_steps": accum_steps,
        }
        self._check_config_consistency(resolved, resume)
        D.barrier(self.mesh)  # every rank has read config.json before rank 0 writes it
        self.writer.config(resolved)
        if self.rank == 0:
            self._snapshot_sources(resume)

        # this rank's rows of each global batch, its share of each global
        # microbatch in order (checked above); the whole batch alone
        self._host_slice = D.host_batch_rows(batch_size, accum_steps) if world > 1 else None
        self.train_loader = BatchLoader(
            train_dataset, batch_size, shuffle=True, seed=seed, device_only=True,
            num_workers=num_workers, host_slice=self._host_slice,
        )
        self.valid_loader = (
            BatchLoader(valid_dataset, batch_size, shuffle=False, seed=seed, drop_last=False)
            if valid_dataset is not None else None
        )
        self.extra_valid_loaders = {
            prefix: BatchLoader(ds, batch_size, shuffle=False, seed=seed, drop_last=False)
            for prefix, ds in (extra_valid_datasets or {}).items()
        }
        steps_per_epoch = max(len(self.train_loader), 1)
        self.state = create_train_state(model, lr=lr, weight_decay=weight_decay,
                                        steps_per_epoch=steps_per_epoch, clip=clip)
        # the plain steps are its one-microbatch case; B not divisible raises
        self._train_step = make_accum_train_step(model, cfg, accum_steps, proj=proj,
                                                 train_target=train_target)
        if self.mesh is not None:
            self._train_step = shard_train_step(self._train_step, self.mesh)
        self._eval_step = (make_eval_step_proj(model, cfg) if proj
                           else make_eval_step(model, cfg, self.state))

        self.ckpt = CheckpointManager(log_dir)
        self.start_epoch = 0
        self.n_iter = 0

        def _fresh_best():
            # acc is maximised, the rest minimised
            return {"rotation": np.inf, "translation": np.inf, "msee": np.inf, "acc": -np.inf}

        self.best = _fresh_best()
        self.extra_best = {p: _fresh_best() for p in self.extra_valid_loaders}
        if resume and self.ckpt.latest_step() is not None:
            payload, meta = self.ckpt.restore()
            restore_train_state(self.state, payload)
            if meta:
                self.start_epoch = int(meta.get("epoch", 0)) + 1
                self.n_iter = int(meta.get("n_iter", 0))
                self.best = {**self.best, **meta.get("best", {})}
                for p, b in (meta.get("extra_best") or {}).items():
                    if p in self.extra_best:
                        self.extra_best[p] = {**self.extra_best[p], **b}
            self._print(f"[trainer] resumed at epoch {self.start_epoch}")
        if self.mesh is not None:
            replicate_(self.model, self.mesh)

    def _print(self, line: str) -> None:
        if self.rank == 0:
            print(line)

    def _snapshot_sources(self, resume: bool) -> None:
        """Archive the port's sources (its .py files and its CUDA kernels'
        csrc/) into the log dir, so a run can be reproduced after the tree
        has moved on. Best effort: a failure never blocks training."""
        path = os.path.join(self.log_dir, "src_snapshot.tar.gz")
        if resume and os.path.exists(path):
            return
        import i2pnet_tpu_torch

        pkg_dir = os.path.dirname(os.path.abspath(i2pnet_tpu_torch.__file__))
        try:
            with tarfile.open(path, "w:gz") as tar:
                tar.add(pkg_dir, arcname="i2pnet_tpu_torch",
                        filter=lambda ti: ti if ti.isdir() or ti.name.endswith(
                            (".py", ".cu", ".cuh")) else None)
        except OSError:
            pass

    def _check_config_consistency(self, resolved: dict, resume: bool) -> None:
        """A resumed run must match its original config."""
        path = os.path.join(self.log_dir, "config.json")
        if resume and os.path.exists(path):
            with open(path) as f:
                old = json.load(f)
            for key in ("config", "batch_size", "proj"):
                if json.dumps(old.get(key), sort_keys=True, default=str) != json.dumps(
                    resolved.get(key), sort_keys=True, default=str
                ):
                    raise ValueError(f"resume config mismatch on '{key}' — refusing to resume")

    def _check_finite(self, metrics: dict) -> None:
        finite = torch.stack([torch.isfinite(metrics["loss"]).all()]
                             + [torch.isfinite(p).all() for p in self.model.parameters()])
        if not bool(finite.all()):
            raise FloatingPointError(
                f"a non-finite loss or parameter after update {self.state.step}")

    def train(self) -> None:
        # dropout: one stream a rank, seeded from (seed, rank)
        generator = torch.Generator(self.device).manual_seed(
            self.seed + 1 + self.rank * 1_000_003)
        try:
            for epoch in range(self.start_epoch, self.epochs):
                t0 = time.time()
                losses = []  # on the device; pulled once at the epoch's end
                for bi, batch in enumerate(prefetch_to_device(self.train_loader, self.device)):
                    m = self._train_step(self.state, to_model_batch(batch), generator)
                    self.n_iter += 1
                    losses.append(m["loss"])
                    if self.debug_nans:
                        self._check_finite(m)
                    if bi % self.save_rate == 0:
                        loss = float(m["loss"])
                        self.writer.add_scalar("train/loss", loss, self.n_iter)
                        self.writer.add_scalar("train/loss_q", m["loss_q"], self.n_iter)
                        self.writer.add_scalar("train/loss_x", m["loss_x"], self.n_iter)
                        self.writer.text_log(
                            "log.txt", f"epoch {epoch} iter {self.n_iter} loss {loss:.6f}")
                # the pull waits for the card, so the epoch's time holds its last step
                mean_loss = float(torch.stack(losses).mean()) if losses else float("nan")
                dt = time.time() - t0
                self.writer.add_scalar("train/epoch_time_s", dt, epoch)
                self._print(f"[trainer] epoch {epoch}: mean loss {mean_loss:.4f} ({dt:.1f}s)")

                if self.valid_loader is not None:
                    self._validate_and_track(self.valid_loader, self.best, "", epoch)
                for prefix, loader in self.extra_valid_loaders.items():
                    self._validate_and_track(loader, self.extra_best[prefix], prefix, epoch)

                self.ckpt.save(epoch, self.state, meta={
                    "epoch": epoch, "n_iter": self.n_iter, "best": self.best,
                    "extra_best": self.extra_best})
                D.barrier(self.mesh)  # rank 0's files are whole before any rank reads them
        finally:
            self.train_loader.close()

    def _validate_and_track(self, loader, best, prefix: str, epoch: int) -> None:
        """Validate one split and snapshot its bests, named with the
        split's prefix ('' is the main split)."""
        val = self.validate(loader)
        tag = f"val_{prefix.rstrip('_')}" if prefix else "val"
        for k, v in val.items():
            self.writer.add_scalar(f"{tag}/{k}", v, epoch)
        self.writer.text_log("log_rotate.txt", f"epoch {epoch} {prefix}rre {val['rre_mean']:.6f}")
        self.writer.text_log("log_trans.txt", f"epoch {epoch} {prefix}rte {val['rte_mean']:.6f}")
        snapshot = {"model": self.model.state_dict()}
        if self.train_target == "class":
            # a classification-only run tracks the mask accuracy alone
            if val["acc"] > best["acc"]:
                best["acc"] = val["acc"]
                self.ckpt.save_best(f"{prefix}model_acc_best", snapshot)
            return
        if val["rre_mean"] < best["rotation"]:
            best["rotation"] = val["rre_mean"]
            self.ckpt.save_best(f"{prefix}model_rotation_best", snapshot)
        if val["rte_mean"] < best["translation"]:
            best["translation"] = val["rte_mean"]
            self.ckpt.save_best(f"{prefix}model_transition_best", snapshot)
        if val["msee"] < best["msee"]:
            best["msee"] = val["msee"]
            self.ckpt.save_best(f"{prefix}model_msee_best", snapshot)
        best["acc"] = max(best["acc"], val["acc"])

    def _mask_accuracy(self, out, mb, batch) -> Optional[np.ndarray]:
        """Per-sample projection-mask accuracy of one validation batch, of
        the head the JAX trainer reads: pm3 where layer_mask[1], else pm4
        where layer_mask[0] (under use_projection_mask), or pm3 of a
        one_head_mask model (without the sigmoid flag); None without one.
        The labels are the head's gt_project, or recomputed at its own
        points under the batch's ground truth."""
        cfg = self.cfg
        if self.proj:
            return None
        if cfg.use_projection_mask:
            if out.get("pm3") is not None and cfg.layer_mask[1]:
                pm, sigmoid = out["pm3"], cfg.mask_sigmoid
            elif out.get("pm4") is not None and cfg.layer_mask[0]:
                pm, sigmoid = out["pm4"], cfg.mask_sigmoid
            else:
                return None
        elif out.get("pm3") is not None and cfg.one_head_mask:
            pm, sigmoid = out["pm3"], False
        else:
            return None
        if len(pm) >= 3 and pm[2] is not None:
            l_gt = pm[2].argmax(-1)
        else:
            q_gt, t_gt = (torch.from_numpy(np.asarray(batch[k])).to(self.device)
                          for k in ("decalib_real_gt", "decalib_dual_gt"))
            l_gt = get_projection_gt(pm[1], mb["intrinsic"], tuple(mb["rgb"].shape[1:3]),
                                     q_gt, t_gt)
        return M.eval_acc(pm[0].float().cpu().numpy(), l_gt.cpu().numpy(), sigmoid=sigmoid)

    def validate(self, loader=None) -> Dict[str, float]:
        """RTE/RRE, the per-axis calibration errors, MSEE and ``acc`` over
        one split (the main one unless ``loader`` is given), with the JAX
        trainer's keys; every value a Python float."""
        ev = M.RteRreEval()
        axis_errs, msees, accs = [], [], []
        loader = loader if loader is not None else self.valid_loader
        for batch in prefetch_to_device(loader, self.device, keys=MODEL_KEYS):
            mb = to_model_batch({k: v for k, v in batch.items() if isinstance(v, torch.Tensor)})
            out = self._eval_step(mb)
            acc = self._mask_accuracy(out, mb, batch)
            if acc is not None:
                accs.append(acc)
            out3 = out["out3"].float().cpu().numpy()
            gt_q = np.asarray(batch["decalib_real_gt"])
            gt_t = np.asarray(batch["decalib_dual_gt"])
            pred_E, gt_E = M.get_extrinsic(out3, gt_q, gt_t, np.asarray(batch["init_extrinsic"]))
            ev.add_batch(pred_E, gt_E)
            axis_errs.append(M.calibration_error_batch(pred_E, gt_E))
            gt_E_raw = np.concatenate([M.quat_to_rotmat_batch(gt_q), gt_t.reshape(-1, 3, 1)], -1)
            msees.append(M.eval_msee(out3, M.extrinsic_to_se3(gt_E_raw)))
        if not axis_errs:
            raise ValueError("validation loader produced no batches — the validation split is "
                             "empty under this root_path")
        rte_mean, rte_std, rre_mean, rre_std = ev.eval_seq()
        axis = np.concatenate([np.stack(a, -1) for a in axis_errs], 0).mean(0)
        val = {
            "rte_mean": rte_mean, "rte_std": rte_std, "rre_mean": rre_mean, "rre_std": rre_std,
            "roll_deg": axis[0], "pitch_deg": axis[1], "yaw_deg": axis[2],
            "x_m": axis[3], "y_m": axis[4], "z_m": axis[5],
            "msee": np.concatenate(msees).mean(),
            # 0.0 without a mask head, as the JAX trainer reports
            "acc": np.concatenate(accs).mean() if accs else 0.0,
        }
        return {k: float(v) for k, v in val.items()}
