"""The ranks of the port's data-parallel tests (tests/test_torch_dp*.py).

``spawn(task, *args)`` starts two gloo ranks on the CPU with the ``spawn``
start method; they rendezvous through a file in the test's tmp dir (no
fixed TCP port, so xdist workers may spawn at once), each runs
``TASKS[task](mesh, rank_dir, *args)`` with one thread and saves what it
returns; ``spawn`` returns the ranks' results in rank order. A rank that
raises fails the call with its traceback. ``spawn(..., join=False)`` gives
the ranks torchrun's whole environment instead (``MASTER_ADDR`` and a
``MASTER_PORT`` the parent found free) and no group: the task joins it
itself, as an entry point under torchrun does, and gets no mesh. This module imports torch and the
port, never JAX: the parent holds the references.
"""

import os
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BF = torch.bfloat16


def _run(rank, world, store, port, task, args, out_dir):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    from i2pnet_tpu_torch.parallel import make_mesh, maybe_initialize_distributed

    mesh = None
    if port is None:
        assert maybe_initialize_distributed(device="cpu", init_method=f"file://{store}")
        mesh = make_mesh("cpu")
    else:
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    try:
        result = TASKS[task](mesh, os.path.join(out_dir, f"rank{rank}"), *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(tmp_path, task, *args, world=2, join=True):
    out_dir = str(tmp_path / f"dp_{task}")
    os.makedirs(out_dir, exist_ok=True)
    for r in range(world):
        os.makedirs(os.path.join(out_dir, f"rank{r}"), exist_ok=True)
    store = os.path.join(out_dir, "store")
    port = None if join else _free_port()
    mp.start_processes(_run, args=(world, store, port, task, args, out_dir), nprocs=world,
                       start_method="spawn", join=True)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def rows_of(a, mesh, n=None):
    """This rank's fan-out rows of a numpy array (``fan_out_rows``) and its
    count of real rows."""
    from i2pnet_tpu_torch.parallel import fan_out_rows

    idx, valid = fan_out_rows(len(a) if n is None else n, mesh)
    return a[idx], valid


def _grads(module):
    return {k: p.grad.detach().clone() for k, p in module.named_parameters()
            if p.grad is not None}


def stage_task(mesh, _dir, state, cin, channels, strides, x, g):
    """The bf16 RGBEncoderStage in training on this rank's rows under the
    mesh: out, the running statistics after the update, the gradients."""
    from i2pnet_tpu_torch.nn.layers import RGBEncoderStage
    from i2pnet_tpu_torch.parallel import set_mesh

    mod = RGBEncoderStage(cin, channels, strides, BF)
    mod.load_state_dict(state)
    mod.train()
    xr, _ = rows_of(x, mesh)
    gr, _ = rows_of(g, mesh)
    with set_mesh(mesh):
        out = mod(torch.from_numpy(xr))
    (out.float() * torch.from_numpy(gr)).sum().backward()
    return {"out": out.float(), "buffers": {k: b.clone() for k, b in mod.named_buffers()},
            "grads": _grads(mod)}


def norms_task(mesh, _dir, n, norm_state, x, gx, pn_state, pn_kw, grids):
    """BatchStatsNorm (forward and backward) and a ProjectPointNet level at
    eval on the dense route, on this rank's fan-out rows of an n-row batch,
    under the mesh with the rank's count of real rows."""
    from i2pnet_tpu_torch.nn.layers import BatchStatsNorm
    from i2pnet_tpu_torch.nn.proj_backbone import ProjectPointNet
    from i2pnet_tpu_torch.parallel import set_mesh

    norm = BatchStatsNorm(x.shape[-1])
    norm.load_state_dict(norm_state)
    xr, valid = rows_of(x, mesh, n)
    gr, _ = rows_of(gx, mesh, n)
    xt = torch.from_numpy(xr).requires_grad_()
    with set_mesh(mesh, valid=valid):
        y = norm(xt)
    (y[:valid] * torch.from_numpy(gr)[:valid]).sum().backward()
    pn = ProjectPointNet(**pn_kw)
    pn.load_state_dict(pn_state)
    pn.eval()
    parts = [torch.from_numpy(rows_of(a, mesh, n)[0]) for a in grids]
    with torch.no_grad(), set_mesh(mesh, valid=valid):
        _, _, feat = pn(*parts, center_mode=True)
    return {"valid": valid, "y": y.detach(), "dx": xt.grad, "grads": _grads(norm),
            "feat": feat}


def build_model(family, cfg_dict):
    from i2pnet_tpu_torch.config import I2PNetConfig, I2PNetProjConfig
    from i2pnet_tpu_torch.models import I2PNet, I2PNetProj

    if family == "proj":
        return I2PNetProj(I2PNetProjConfig(**cfg_dict), device="cpu")
    return I2PNet(I2PNetConfig(**cfg_dict), device="cpu")


def step_task(mesh, _dir, family, cfg_dict, state, batch, lr):
    """One DP train step of the family's model on this rank's rows (the
    parameters broadcast from rank 0 first): metrics, the averaged
    gradients, the parameters and statistics after the update."""
    from i2pnet_tpu_torch.parallel import replicate_, shard_train_step
    from i2pnet_tpu_torch.train import create_train_state, make_train_step, make_train_step_proj

    model = build_model(family, cfg_dict)
    if mesh.rank == 0:
        model.load_state_dict(state)
    replicate_(model, mesh)
    st = create_train_state(model, lr=lr, steps_per_epoch=10)
    make = make_train_step_proj if family == "proj" else make_train_step
    step = shard_train_step(make(model, model.cfg), mesh)
    rows = {k: torch.from_numpy(rows_of(v, mesh)[0]) for k, v in batch.items()}
    metrics = step(st, rows)
    return {"metrics": {k: v.clone() for k, v in metrics.items()}, "grads": _grads(model),
            "params": {k: p.detach().clone() for k, p in model.named_parameters()},
            "buffers": {k: b.clone() for k, b in model.named_buffers()}}


def accum_step_task(mesh, _dir, family, cfg_dict, state, batch, lr, accum_steps):
    """One DP accumulating step (``make_accum_train_step``) of the family's
    model, twice from the same state: on this rank's rows grouped by
    microbatch (``host_batch_rows``, as the Trainer loads them) and on its
    contiguous rows (``host_batch_slice``, the grouping before it). Each
    run's metrics, averaged gradients and statistics after the update."""
    from i2pnet_tpu_torch.parallel import (host_batch_rows, host_batch_slice, replicate_,
                                           shard_train_step)
    from i2pnet_tpu_torch.train import create_train_state, make_accum_train_step

    B = len(batch["rgb"])
    out = {}
    for name, rows in (("grouped", host_batch_rows(B, accum_steps)),
                       ("contiguous", np.arange(B)[host_batch_slice(B)])):
        model = build_model(family, cfg_dict)
        if mesh.rank == 0:
            model.load_state_dict(state)
        replicate_(model, mesh)
        st = create_train_state(model, lr=lr, steps_per_epoch=10)
        step = shard_train_step(
            make_accum_train_step(model, model.cfg, accum_steps, proj=family == "proj"), mesh)
        metrics = step(st, {k: torch.from_numpy(v[rows]) for k, v in batch.items()})
        out[name] = {"rows": rows, "metrics": {k: v.clone() for k, v in metrics.items()},
                     "grads": _grads(model),
                     "buffers": {k: b.clone() for k, b in model.named_buffers()}}
    return out


def evaluator_task(mesh, rank_dir, family, cfg_dict, states, samples, batch_size, cv1_model):
    """The DP Evaluator (a cascade of one model a state) over the samples:
    rank 0's summary, the out3 it scores, and its files; the other ranks'
    files. With cv1_model, a free config (that fuses cv1) and its state,
    also each cv1 call of its forward on this rank's rows of the first
    batch under the mesh."""
    from i2pnet_tpu_torch import metrics as M
    from i2pnet_tpu_torch.data import BatchLoader
    from i2pnet_tpu_torch.eval import Evaluator
    from i2pnet_tpu_torch.ops import cv_cuda
    from i2pnet_tpu_torch.parallel import set_mesh

    models = []
    for st in states:
        m = build_model(family, cfg_dict)
        m.load_state_dict(st)
        models.append(m.eval())
    scored = []
    real = M.get_extrinsic

    def recording(out3, *a, **k):
        scored.append(np.array(out3))
        return real(out3, *a, **k)

    M.get_extrinsic = recording
    log_dir = os.path.join(rank_dir, "eval")
    ev = Evaluator(models, models[0].cfg, proj=family == "proj", log_dir=log_dir, mesh=mesh,
                   device="cpu")
    summary = ev.validate(BatchLoader(samples, batch_size, shuffle=False, drop_last=False))
    M.get_extrinsic = real
    out = {"summary": summary, "scored": scored,
           "files": sorted(os.listdir(log_dir)) if os.path.isdir(log_dir) else []}
    if summary is not None:
        with open(os.path.join(log_dir, "prediction.txt")) as f:
            out["prediction"] = f.read()
    if cv1_model is not None:
        cv1_calls = []
        plain = cv_cuda.cv1

        def spy(*ops):
            cv1_calls.append((tuple(o.clone() for o in ops), plain(*ops)))
            return cv1_calls[-1][1]

        cv_cuda.cv1 = spy
        model = build_model("free", cv1_model[0])
        model.load_state_dict(cv1_model[1])
        model.eval()
        first = [samples[i] for i in range(min(batch_size, len(samples)))]
        rows = {k: torch.from_numpy(rows_of(np.stack([s[k] for s in first]), mesh)[0])
                for k in ("rgb", "lidar", "init_intrinsic", "raw_point_xyz")}
        with torch.no_grad(), set_mesh(mesh):
            model(rows["rgb"], rows["lidar"], rows["init_intrinsic"], raw_xyz=rows["raw_point_xyz"])
        cv_cuda.cv1 = plain
        out["cv1"] = cv1_calls
    return out


def train_cli_task(mesh, rank_dir, argv, resume_argv):
    """train_torch.main under the group, then again with --resume: each
    run's update count and parameters, and the files under the log dir."""
    import train_torch

    runs = []
    for a in (argv, resume_argv):
        trainer = train_torch.main(a)
        trainer.writer.close()
        runs.append({"step": trainer.state.step, "start_epoch": trainer.start_epoch,
                     "params": {k: p.detach().clone()
                                for k, p in trainer.model.named_parameters()}})
    return runs


def evaluate_cli_task(_mesh, rank_dir, argv):
    """evaluate_torch.main(argv + --dp) under torchrun's environment, with
    this rank's own --log_dir: it joins the group and leaves it. Its
    summary (None on rank 1), whether a group is left, and the files under
    the log dir."""
    import evaluate_torch

    log_dir = os.path.join(rank_dir, "eval")
    summary = evaluate_torch.main(argv + ["--dp", "--log_dir", log_dir])
    return {"summary": summary, "left": not dist.is_initialized(),
            "files": sorted(os.listdir(log_dir)) if os.path.isdir(log_dir) else []}


def dense_passes_task(mesh, _dir, n, grids, layers):
    """A dense eval level's 2L + 1 passes (``dense_window.dense_level_passes``,
    the op's plain version) on this rank's fan-out rows of an n-row batch,
    under the mesh with the rank's count of real rows."""
    from i2pnet_tpu_torch.ops import dense_window
    from i2pnet_tpu_torch.parallel import set_mesh

    raw, xyz, feat = (torch.from_numpy(rows_of(a, mesh, n)[0]) for a in grids)
    valid = rows_of(grids[0], mesh, n)[1]
    m = dense_window.window_multiplicity(xyz, out_h=4, out_w=8, qstride=(2, 2),
                                         kernel_size=(3, 5), K=4, distance=1.5)
    layers = [tuple(torch.from_numpy(a) for a in layer) for layer in layers]
    with torch.no_grad(), set_mesh(mesh, valid=valid):
        feat = dense_window.dense_level_passes(raw, xyz, feat, m, layers, out_h=4, out_w=8,
                                               qstride=(2, 2), kernel_size=(3, 5), nsample=4,
                                               mode="diff_feature", bf16=False)
    return {"valid": valid, "feat": feat}


TASKS = {"stage": stage_task, "norms": norms_task, "step": step_task,
         "accum_step": accum_step_task,
         "evaluator": evaluator_task, "train_cli": train_cli_task,
         "evaluate_cli": evaluate_cli_task, "dense_passes": dense_passes_task}
