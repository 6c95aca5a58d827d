"""Evaluation harness (port of ``i2pnet_tpu/eval/evaluator.py``).

Per-batch synchronised timing (mean_fps / mean_time_s), RTE/RRE and the
per-axis calibration errors on the decalibration matrices, section-framed
prediction.txt rows (init/pred/gt extrinsics, 9 decimals), a metrics npz
for offline recall analysis, and the cascade protocol: each stage's model
sees the cloud warped by the poses composed so far, and the stages' poses
compose (ref evaluation_cmr.py:330-377). The files and the summary's keys
are the JAX package's, so either package's ``analysis`` reads either's.

One module per cascade stage: the models share a config and each holds its
own weights. Every stage runs through ``train/step.py``'s eval step, and
every stage of an efgh cascade gets the batch's calibration matrix
(``calib``) unchanged, only the cloud moves.

With a mesh (``parallel/mesh.py``; ``evaluate_torch.py --dp`` under
torchrun) the batches fan out over the ranks: every rank draws the same
batches, takes ceil(n / W) rows of each (the tail repeating the last row,
the JAX package's pad-and-trim) and runs the cascade on them under the
mesh with its count of real rows, so the projection family's batch
statistics take the real rows of every rank alone; out3 is gathered and
rank 0 alone computes the metrics, writes the files and draws the
overlays. ``validate`` returns the summary on rank 0 and None elsewhere.
The fan-out gives the single-process evaluator's out3. (The JAX package's
pads enter its proj statistics on a ragged batch, so there the port's
``--dp`` is JAX's single-device evaluator, not its ``--dp``.)
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from i2pnet_tpu_torch import metrics as M
from i2pnet_tpu_torch.data.pipeline import BatchLoader, prefetch_to_device, to_model_batch
from i2pnet_tpu_torch.models.i2pnet import resolve_device
from i2pnet_tpu_torch.ops import quaternion as Q
from i2pnet_tpu_torch.parallel.mesh import Mesh, fan_out_rows, gather_rows, set_mesh
from i2pnet_tpu_torch.train.step import make_eval_step, make_eval_step_proj
from i2pnet_tpu_torch.utils.trace import span

SECTION = "§"  # section-sign framing (ref evaluation_proj.py:145-167)

# the loader keys the forward reads; they alone go to the device, the
# ground truth and the extrinsics stay on the host for the metrics
MODEL_KEYS = ("rgb", "lidar", "lidar_feats", "raw_point_xyz", "init_intrinsic", "calib")


class Evaluator:
    def __init__(
        self,
        models: Sequence[torch.nn.Module],  # one per cascade stage
        cfg,
        proj: bool = False,
        log_dir: str = "info_test",
        tag: str = "",
        writer=None,
        vis_rate: int = 0,
        mesh=None,
        device=None,
        debug_nans: bool = False,
    ):
        """writer, vis_rate: with a writer (``utils/monitor.py`` ``UniWriter``)
        and vis_rate=N, sample 0 of every Nth batch is drawn as init, pred
        and gt projection overlays (``_log_projection_images``); 0 draws
        none. mesh: a ``parallel.Mesh`` fans the batches out over its ranks
        (module docstring). device: the models' device, the card unless
        ``"cpu"`` is given (without a card that raises). debug_nans: check
        every stage's out3/out4 with ``torch.isfinite`` and raise on the
        first non-finite batch."""
        self.device = resolve_device(device)
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh: expected a parallel.Mesh, got {type(mesh).__name__}")
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"the mesh lies on {mesh.device}, the evaluator on {self.device}")
        self.mesh = mesh
        self.models = list(models)
        for m in self.models:
            dev = next(m.parameters()).device
            if dev.type != self.device.type:
                raise ValueError(f"a cascade stage lies on {dev}, the evaluator on {self.device}")
        make = make_eval_step_proj if proj else make_eval_step
        self._steps = [make(m, cfg) for m in self.models]
        self.cfg = cfg
        self.proj = proj
        self.log_dir = log_dir
        self.tag = tag
        self.debug_nans = debug_nans
        # projection-image fan-out (ref evaluation.py:630-657 logs the
        # init/pred/gt overlays and an NHWC comparison batch to the writer)
        self.writer = writer
        self.vis_rate = int(vis_rate)
        self._vis_step = 0
        if mesh is None or mesh.rank == 0:
            os.makedirs(log_dir, exist_ok=True)

    def _check_finite(self, out: dict, stage: int, bi: int) -> None:
        for key in ("out3", "out4"):
            if not bool(torch.isfinite(out[key]).all()):
                raise FloatingPointError(f"non-finite {key} at cascade stage {stage}, batch {bi}")

    def _log_projection_images(self, rgb, lidar, intrinsic, out3_np, q_gt, t_gt) -> None:
        """The writer's init/pred/gt projection overlays of sample 0 (ref
        evaluation.py:630-657: three add_image calls and one NHWC
        add_images comparison batch, the same tags), drawn on the host from
        the model batch's first row."""
        from i2pnet_tpu_torch.eval.visualize import decalib_extrinsic, render_projection

        rgb_u8 = np.clip(rgb[0], 0, 255).astype(np.uint8)
        pts = lidar[0]
        intr = intrinsic[0]
        # the model's input cloud already sits in the decalibrated frame, so
        # "init" projects through the identity and pred/gt through the
        # corrections (the frame convention of tools/render_demo_torch.py)
        panels = {
            "init_projected_img": render_projection(
                rgb_u8, pts, np.eye(3, 4, dtype=np.float32), intr),
            "pj_projected_img": render_projection(
                rgb_u8, pts, decalib_extrinsic(out3_np[0, :4], out3_np[0, 4:]), intr),
            "gt_projected_img": render_projection(
                rgb_u8, pts, decalib_extrinsic(q_gt[0], t_gt[0]), intr),
        }
        for tag, img in panels.items():
            self.writer.add_image(tag, img, self._vis_step)
        self.writer.add_images("comparison_img", np.stack(list(panels.values())), self._vis_step)
        self._vis_step += 1

    def cascade(self, mb: dict, bi: int = 0) -> torch.Tensor:
        """out3 (B, 7) of the cascade on one model batch (tensors on the
        device): each stage after the first sees the original cloud warped
        by the composed pose of the stages before it. ``bi`` names the
        batch in a debug_nans error."""
        q_acc = t_acc = None
        stage_batch = mb
        with span("i2pnet/eval/cascade"), torch.inference_mode():
            for si, step in enumerate(self._steps):
                with span(f"i2pnet/eval/stage{si}"):
                    out = step(stage_batch)
                if self.debug_nans:
                    self._check_finite(out, si, bi)
                out3_s = out["out3"]
                if q_acc is None:
                    q_acc, t_acc = out3_s[:, :4], out3_s[:, 4:]
                else:
                    q_acc, t_acc = Q.compose_pose(out3_s[:, :4], out3_s[:, 4:], q_acc, t_acc)
                if si + 1 < len(self._steps):
                    stage_batch = dict(mb, lidar=Q.warp_points(mb["lidar"], q_acc, t_acc))
            return torch.cat([q_acc, t_acc], dim=1)

    def _rank_rows(self, loader):
        """The loader's batches; under a mesh, the model keys cut to this
        rank's rows (``fan_out_rows``), with ``_fan_out`` = (the batch's
        rows, this rank's real ones). The host keys (ground truth,
        extrinsics, path_info) stay whole for rank 0's metrics."""
        for batch in loader:
            if self.mesh is None:
                yield batch
                continue
            n = len(batch["rgb"])
            idx, valid = fan_out_rows(n, self.mesh)
            rows = {k: v[idx] for k, v in batch.items()
                    if k in MODEL_KEYS and isinstance(v, np.ndarray)}
            yield {**batch, **rows, "_fan_out": (n, valid)}

    def validate(self, loader: BatchLoader, save_metrics: bool = True) -> Dict:
        ev = M.RteRreEval()
        axis_errs: List = []
        batch_times: List = []
        pred_lines: List[str] = []
        msee_all: List[np.ndarray] = []
        cuda = self.device.type == "cuda"

        batches = prefetch_to_device(self._rank_rows(loader), self.device, keys=MODEL_KEYS)
        for bi, batch in enumerate(batches):
            mb = to_model_batch({k: v for k, v in batch.items() if isinstance(v, torch.Tensor)})
            mb.setdefault("raw_xyz", mb["lidar"])

            # the timed window: from the batch on the device and the device
            # idle to out3 on the host (every rank's, gathered)
            if cuda:
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            if self.mesh is None:
                out3 = self.cascade(mb, bi)
            else:
                n, valid = batch["_fan_out"]
                with set_mesh(self.mesh, valid=valid):
                    out3 = gather_rows(self.cascade(mb, bi), n, self.mesh)
                if self.mesh.rank != 0:
                    continue
            out3_np = out3.cpu().numpy()
            batch_times.append((time.perf_counter() - t0, out3_np.shape[0]))

            q_gt = np.asarray(batch["decalib_real_gt"])
            t_gt = np.asarray(batch["decalib_dual_gt"])
            init_E = np.asarray(batch["init_extrinsic"])
            pred_E, gt_E, pred_raw, gt_raw = M.get_extrinsic(
                out3_np, q_gt, t_gt, init_E, out_raw=True
            )
            ev.add_batch(pred_E, gt_E)
            axis_errs.append(M.calibration_error_batch(pred_E, gt_E))
            gt_se3 = M.extrinsic_to_se3(gt_raw)
            msee_all.append(M.eval_msee(out3_np, gt_se3, pred_E=pred_raw))

            if self.writer is not None and self.vis_rate and bi % self.vis_rate == 0:
                self._log_projection_images(
                    *(mb[k][:1].float().cpu().numpy() for k in ("rgb", "lidar", "intrinsic")),
                    out3_np, q_gt, t_gt)

            for b in range(out3_np.shape[0]):
                path_info = batch["path_info"][b] if "path_info" in batch else str(b)
                rows = [f"{SECTION} {path_info}"]
                for name, mat in (("init", init_E[b]), ("pred", pred_E[b]), ("gt", gt_E[b])):
                    vals = " ".join("%.9f" % v for v in np.asarray(mat).reshape(-1))
                    rows.append(f"{name} {vals}")
                pred_lines.append("\n".join(rows))

        if self.mesh is not None and self.mesh.rank != 0:
            return None
        rte_mean, rte_std, rre_mean, rre_std = ev.eval_seq()
        axis = np.concatenate([np.stack(a, -1) for a in axis_errs], 0).mean(0)
        # timing protocol, as the JAX package's: only FULL batches count,
        # minus the first of them. The first absorbs the first launches,
        # cuBLAS's set-up and the kernels' build; a ragged final batch has
        # other shapes and is left out rather than skew mean_time. Host
        # preprocessing and the copy to the device stay outside the window.
        bsz = loader.batch_size
        full = [t for t, n in batch_times if n == bsz]
        timed = full[1:]
        timing_includes_compile = False
        if timed:
            mean_time = float(np.mean(timed))
            mean_fps = bsz / mean_time if mean_time > 0 else float("nan")
        else:
            # zero or one full batch: no warm full-batch sample, so report
            # aggregate throughput and flag that the first launches are in it
            timing_includes_compile = True
            tot_t = sum(t for t, _ in batch_times)
            tot_n = sum(n for _, n in batch_times)
            mean_time = tot_t / max(len(batch_times), 1)
            mean_fps = tot_n / tot_t if tot_t > 0 else float("nan")
        summary = {
            "rte_mean": rte_mean,
            "rte_std": rte_std,
            "rre_mean": rre_mean,
            "rre_std": rre_std,
            "roll_deg": axis[0],
            "pitch_deg": axis[1],
            "yaw_deg": axis[2],
            "x_m": axis[3],
            "y_m": axis[4],
            "z_m": axis[5],
            "msee": float(np.concatenate(msee_all).mean()),
            "mean_time_s": mean_time,
            "mean_fps": mean_fps,
            "timing_includes_compile": timing_includes_compile,
            "count": ev.all_count,
        }

        ts = time.strftime("%Y%m%d_%H%M%S")
        with open(os.path.join(self.log_dir, f"log_test{self.tag}.txt"), "a") as f:
            f.write(" ".join(f"{k}={v}" for k, v in summary.items()) + "\n")
        with open(os.path.join(self.log_dir, f"prediction{self.tag}.txt"), "w") as f:
            f.write("\n".join(pred_lines) + "\n")
        if save_metrics:
            ev.save_metric(os.path.join(self.log_dir, f"metrics_{ts}.npz"))
        return summary
