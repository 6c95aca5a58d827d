"""The evaluator's closed loop: the next batch to the card through
``prefetch_to_device``, then, from the card idle, the cascade
(``Evaluator.cascade``) and out3 on the host, one latency a batch. The
check compares each cascade stage's out3 and out4 of ``checked`` pool
batches, as the window produced them, with the reference's."""

from __future__ import annotations

import math
import shutil
import tempfile
import time

import torch

from h100_bench import gen
from h100_bench.harness import calibrate, resolve, sync, to_device
from h100_bench.reference import nets
from h100_bench.reference.quant import CASTS

def faults(family) -> tuple:
    """Answers can be altered everywhere; a mean over the batch exists at
    eval only where the family's norms take the batch's statistics."""
    return ("swap_answers", "one_row") + (("half_batch",) if family.BATCH_STATS_AT_EVAL else ())


def prepare(ctx) -> None:
    calib = to_device(gen.calibration_batch(ctx.seed, ctx.cell.config, ctx.traffic), ctx.device)
    for W in ctx.weights:
        calibrate(ctx.family, ctx.mc, W, calib)
    del calib
    ctx.phase("calibration")


class Recorder:
    """Keeps each cascade stage's out3 and out4 of the window's batches in
    ``slots`` (the first time each comes), as the program produced them."""

    def __init__(self, slots):
        self.want, self.got, self.cur, self.buf = set(slots), {}, None, []

    def wrap(self, step):
        def recorded(batch):
            out = step(batch)
            if self.cur is not None:
                self.buf.append((out["out3"].detach().clone(), out["out4"].detach().clone()))
            return out
        return recorded

    def arm(self, slot):
        self.cur = slot if slot in self.want and slot not in self.got else None
        self.buf = []

    def disarm(self):
        if self.cur is not None:
            self.got[self.cur] = self.buf
        self.cur = None


def build(ctx) -> None:
    prog, spec = ctx.prog, ctx.cell.config["program"]
    prog.log_dir = tempfile.mkdtemp(prefix="h100_bench_eval_")
    prog.ev = resolve(spec["evaluator"])(prog.models, prog.cfg, log_dir=prog.log_dir,
                                         device=ctx.device, **spec.get("evaluator_args", {}))


def warm(ctx) -> int:
    # the recorder wraps each stage outermost, over any planted fault
    slots = gen.rng_for(ctx.seed, 4).choice(len(ctx.pool), ctx.traffic["checked"], replace=False)
    ctx.rec = Recorder([int(s) for s in slots])
    ctx.prog.ev._steps = [ctx.rec.wrap(s) for s in ctx.prog.ev._steps]
    return run(ctx, 0, count=ctx.traffic["warmup"])["next"]


def run(ctx, start: int, seconds=None, count=None, record=False) -> dict:
    """Stops after ``count`` batches or once ``seconds`` have passed."""
    from i2pnet_tpu_torch.data.pipeline import prefetch_to_device, to_model_batch
    from i2pnet_tpu_torch.eval.evaluator import MODEL_KEYS

    pool, prog, rec = ctx.pool, ctx.prog, ctx.rec if record else None
    n = len(pool)

    def feed():
        i = start
        while True:
            yield dict(pool[i % n], _slot=i % n)
            i += 1

    lat, done = [], 0
    t_start = t1 = time.perf_counter()
    for bi, batch in enumerate(prefetch_to_device(feed(), ctx.device, keys=MODEL_KEYS)):
        mb = to_model_batch({k: v for k, v in batch.items() if isinstance(v, torch.Tensor)})
        mb.setdefault("raw_xyz", mb["lidar"])
        sync(ctx.device)
        t0 = time.perf_counter()
        if rec is not None:
            rec.arm(batch["_slot"])
        prog.ev.cascade(mb, bi).cpu().numpy()
        t1 = time.perf_counter()
        if rec is not None:
            rec.disarm()
        lat.append(t1 - t0)
        done += 1
        if (count is not None and done >= count) or (seconds is not None
                                                     and t1 - t_start >= seconds):
            break
    return dict(units=done, seconds=t1 - t_start, latencies=lat, next=start + done)


def end_to_end(ctx, win) -> dict:
    lat = sorted(win["latencies"])
    return {"eval_pairs_per_s": win["units"] * ctx.B / win["seconds"],
            "eval_batch_ms_p95": 1e3 * lat[max(math.ceil(0.95 * len(lat)) - 1, 0)]}


def release(ctx) -> None:
    ctx.recorded = ctx.rec.got
    ctx.rec = None
    shutil.rmtree(ctx.prog.log_dir, ignore_errors=True)


def outputs(family, mc, weights, b, candidate=None, cast=None):
    """Per cascade stage, the reference's (out3, out4) and the candidate's:
    the recorded program outputs, or (``candidate`` None) the reference
    itself under ``cast`` (the control). Every stage after the first sees
    the cloud warped by the candidate's composed pose, as the cascade
    warps it."""
    pairs, q_acc, t_acc = [], None, None
    fwd = nets.forward(family)
    for si, W in enumerate(weights):
        lidar = b["lidar"] if q_acc is None else nets.warp_points(b["lidar"], q_acc, t_acc)
        args = (mc, b["rgb"], lidar, b["intrinsic"], b["lidar_feats"], b["raw_xyz"])
        ref = fwd(nets.Run(W), *args)
        cand = fwd(nets.Run(W, cast=cast), *args) if candidate is None else candidate[si]
        pairs.append((cand, ref))
        c3 = cand[0]
        if q_acc is None:
            q_acc, t_acc = c3[:, :4], c3[:, 4:]
        else:
            q_acc, t_acc = nets.compose_pose(c3[:, :4], c3[:, 4:], q_acc, t_acc)
    return pairs


def numbers(blocks) -> dict:
    """``blocks``: per checked batch, ``outputs``' (candidate, reference)
    of each stage. A pair's q is the widest gap of a quaternion component
    over every stage and both outputs (out3, out4), its t that of a
    translation component over the batch's largest reference translation.
    q_gap and t_gap are the widest over the pairs, q_med and t_med the
    median pair's, q_p90 and t_p90 the 90th percentile pair's (a fault in
    one row of each batch shows there, not in the median); ``_per_pair``
    (pairs, 2) counts the failed answers and ``_where`` names the stage and
    output of the widest gaps."""
    rows, where = [], {}
    for bi, stages in enumerate(blocks):
        block = None
        for si, (cand, ref) in enumerate(stages):
            for name, c, r in zip(("out3", "out4"), cand, ref):
                c, r = c.float(), r.float()
                dq = (c[:, :4] - r[:, :4]).abs().amax(1)
                dt = (c[:, 4:] - r[:, 4:]).abs().amax(1) / r[:, 4:].abs().amax().clamp(min=1e-6)
                pp = torch.stack([dq, dt], 1).cpu()
                pp[~torch.isfinite(c).all(1).cpu()] = math.inf
                for j, key in enumerate(("q", "t")):
                    if float(pp[:, j].max()) > where.get(key, (-1.0, ""))[0]:
                        where[key] = (float(pp[:, j].max()), f"batch {bi} stage {si} {name}")
                block = pp if block is None else torch.maximum(block, pp)
        rows.append(block)
    per_pair = torch.cat(rows)
    med = per_pair.median(0).values
    # nearest rank: with one checked batch of 8 in three, the 90th
    # percentile pair is the third widest, so one wrong row in each batch
    # reaches it
    p90 = per_pair.sort(0).values[max(math.ceil(0.9 * len(per_pair)) - 1, 0)]
    return {"q_gap": float(per_pair[:, 0].max()), "t_gap": float(per_pair[:, 1].max()),
            "q_med": float(med[0]), "t_med": float(med[1]),
            "q_p90": float(p90[0]), "t_p90": float(p90[1]), "_per_pair": per_pair,
            "_where": {k: v[1] for k, v in where.items()}}


def check(ctx, control, count_flops):
    from h100_bench.harness import flops_counter

    blocks, ctrl_blocks, flops = [], [], None
    with torch.no_grad():
        for i, (slot, outs) in enumerate(sorted(ctx.recorded.items())):
            b = to_device(ctx.pool[slot], ctx.device)
            counter = flops_counter(count_flops and i == 0)
            with counter:
                blocks.append(outputs(ctx.family, ctx.mc, ctx.weights, b, candidate=outs))
            if count_flops and i == 0:
                flops = float(counter.get_total_flops())
            if control:
                ctrl_blocks.append(outputs(ctx.family, ctx.mc, ctx.weights, b,
                                           cast=CASTS[control]))
    nums = numbers(blocks) if blocks else dict.fromkeys(
        ("q_gap", "t_gap", "q_med", "t_med", "q_p90", "t_p90"), math.inf)
    return nums, (numbers(ctrl_blocks) if control else None), flops


def failed(ctx, nums) -> int:
    """Every answer checked."""
    return len(nums["_per_pair"]) if "_per_pair" in nums else ctx.B * ctx.traffic["checked"]

