"""The trainer's loop: each step (``make_train_step`` and its kin) on a
batch copied to the card without blocking, dispatched with no host
synchronisation between steps; one synchronisation closes a run of steps.
Set-up builds one ``TrainState`` and drives it through its first three
steps, whose losses, first gradient as Adam takes it and parameters'
change the check compares with the reference's own three steps; the window
continues the same state."""

from __future__ import annotations

import math
import statistics
import time

import torch

from h100_bench import gen
from h100_bench.harness import resolve, sub_seed, sync, to_device
from h100_bench.reference import train as rtrain
from h100_bench.reference.quant import CASTS

# a leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone under Adam: its change is not compared
TINY_GRAD = 1e-3
CHECKED_STEPS = 3


def faults(family) -> tuple:
    """A state, an optimizer update and a mean over the batch."""
    return ("unchanged_state", "half_batch", "adam_lr_double", "adam_no_bias_correction")


def prepare(ctx) -> None:
    pass


def build(ctx) -> None:
    from i2pnet_tpu_torch.train.state import create_train_state

    prog, spec = ctx.prog, ctx.cell.config["program"]
    model = prog.models[0]
    prog.state = create_train_state(model, steps_per_epoch=ctx.traffic["steps_per_epoch"])
    prog.step = resolve(spec["train_step"])(model, prog.cfg)
    prog.gen = torch.Generator(device=ctx.device)
    prog.gen.manual_seed(sub_seed(ctx.seed, 3))
    feed = [gen.model_keys(b) for b in ctx.pinned]
    ctx.batch_at = lambda k: {key: v.to(ctx.device, non_blocking=True)
                              for key, v in feed[k % len(feed)].items()}


def warm(ctx) -> int:
    prog = ctx.prog
    names = [n for n, _ in prog.models[0].named_parameters()]
    params = dict(prog.models[0].named_parameters())
    losses = []
    for k in range(CHECKED_STEPS):
        m = prog.step(prog.state, ctx.batch_at(k), prog.gen)
        losses.append(m["loss"].detach().clone())
        if k == 0:
            # Adam's first moment after one update is (1 - 0.9) x the
            # gradient it took, weight decay included
            st = prog.state.optimizer.state
            grad1 = {n: st[params[n]]["exp_avg"].norm() / 0.1 if params[n] in st
                     else torch.zeros((), device=ctx.device) for n in names}
    change = {n: (params[n].detach() - ctx.weights[0][n]).norm() for n in names}
    ctx.names, ctx.first = names, (losses, grad1, change)
    return run(ctx, CHECKED_STEPS, count=ctx.traffic["warmup"])["next"]


def run(ctx, start: int, seconds=None, count=None, record=False) -> dict:
    prog = ctx.prog
    t_start = time.perf_counter()
    k = start
    while True:
        prog.step(prog.state, ctx.batch_at(k), prog.gen)
        k += 1
        if (count is not None and k - start >= count) or (
                seconds is not None and time.perf_counter() - t_start >= seconds):
            break
    sync(ctx.device)
    return dict(units=k - start, seconds=time.perf_counter() - t_start, next=k)


def end_to_end(ctx, win) -> dict:
    return {"train_pairs_per_s": win["units"] * ctx.B / win["seconds"]}


def release(ctx) -> None:
    losses, grad1, change = ctx.first
    ctx.prog_read = dict(loss=[float(v) for v in losses],
                         grad={n: float(v) for n, v in grad1.items()},
                         change={n: float(v) for n, v in change.items()})
    ctx.first = ctx.batch_at = None


def readings(family, mc, W, batches, uniforms, names, cast=None, count_flops=False):
    """The reference's three steps from W: each step's loss, the first
    gradient as Adam takes it (and the bare one), and the parameters'
    change after the three, per leaf; FLOPs of the first step's forward
    and backward where asked."""
    from h100_bench.harness import flops_counter

    P = {n: W[n].clone() for n in W}
    opt = rtrain.Adam({n: P[n] for n in names}, steps_per_epoch=mc["_steps_per_epoch"])
    losses, flops = [], None
    for k in range(CHECKED_STEPS):
        counter = flops_counter(count_flops and k == 0)
        with counter:
            loss, grads = rtrain.loss_and_grads(family, mc, P, batches[k],
                                                uniforms[2 * k: 2 * k + 2], cast=cast,
                                                trainable=names)
        if count_flops and k == 0:
            flops = counter.get_total_flops()
        seen = opt.step(P, grads)
        losses.append(float(loss))
        if k == 0:
            grad = {n: float(seen[n].norm()) for n in names}
            bare = {n: float(grads[n].norm()) for n in names}
    change = {n: float((P[n] - W[n]).norm()) for n in names}
    return dict(loss=losses, grad=grad, bare=bare, change=change, flops=flops)


def numbers(cand: dict, ref: dict) -> dict:
    """loss_gap: the widest relative gap of a step's loss (loss1_gap: the
    first step's); grad_gap and change_gap: the worst leaf's gap of norms,
    over the larger of the reference leaf's norm and the median leaf's,
    on the leaves whose reference gradient is not nought to rounding
    (under ``TINY_GRAD`` of the median leaf's: a bias ahead of a
    batch-statistics norm, whose gradient is round-off on either side);
    grad_med and change_med the median leaf's gap; grad_gap_all takes every
    leaf. ``_where`` names the worst leaves."""
    gaps = [abs(c - r) / max(abs(r), 1e-12) for c, r in zip(cand["loss"], ref["loss"])]
    gaps = [g if math.isfinite(g) else math.inf for g in gaps]
    med_b = statistics.median(ref["bare"].values())
    kept = [n for n, g in ref["bare"].items() if g >= TINY_GRAD * med_b]

    def leaf_gaps(key, names):
        med = statistics.median(ref[key][n] for n in names)
        return sorted(((abs(cand[key][n] - ref[key][n]) / max(ref[key][n], med))
                       if math.isfinite(cand[key][n]) else math.inf, n) for n in names)

    g_all, g_kept, ch = leaf_gaps("grad", list(ref["grad"])), leaf_gaps("grad", kept), leaf_gaps(
        "change", kept)
    return {"loss_gap": max(gaps), "loss1_gap": gaps[0], "grad_gap": g_kept[-1][0],
            "grad_gap_all": g_all[-1][0], "change_gap": ch[-1][0],
            "grad_med": g_kept[len(g_kept) // 2][0], "change_med": ch[len(ch) // 2][0],
            "_where": {"grad_gap": g_kept[-1][1], "grad_gap_all": g_all[-1][1],
                       "change_gap": ch[-1][1], "loss_steps": gaps}}


def check(ctx, control, count_flops):
    gref = torch.Generator(device=ctx.device)
    gref.manual_seed(sub_seed(ctx.seed, 3))
    hidden = ctx.mc["head_hidden_dim"]
    # the program's dropout draws, replayed: two heads a step
    uniforms = [torch.rand((ctx.B, 1, hidden), generator=gref, device=ctx.device)
                for _ in range(2 * CHECKED_STEPS)]
    batches = [to_device(ctx.pool[k], ctx.device) for k in range(CHECKED_STEPS)]
    ref = readings(ctx.family, ctx.mc, ctx.weights[0], batches, uniforms, ctx.names,
                   count_flops=count_flops)
    ctrl = None
    if control:
        ctrl = numbers(readings(ctx.family, ctx.mc, ctx.weights[0], batches, uniforms,
                                ctx.names, cast=CASTS[control]), ref)
    return numbers(ctx.prog_read, ref), ctrl, ref["flops"]


def failed(ctx, nums) -> int:
    """The batch of every step checked."""
    return ctx.B
