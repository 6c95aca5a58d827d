"""Faults planted in the program's timed path, to show that the check
catches them (``tests/test_h100_bench_faults.py`` on the CPU,
``control.py --fault`` on the card). Each takes the harness's program
object after it is built. The benchmark's own runs plant none."""

from __future__ import annotations

import torch


def swap_answers(prog) -> None:
    """Every cascade stage hands each pair the answer of its neighbour."""
    def wrap(step):
        def swapped(batch):
            out = step(batch)
            return dict(out, out3=out["out3"].roll(1, 0), out4=out["out4"].roll(1, 0))
        return swapped
    prog.ev._steps = [wrap(s) for s in prog.ev._steps]


def half_batch(prog) -> None:
    """Means over the batch are taken over half of it: a train step's loss
    and statistics over the first half of its rows; an eval stage of the
    projection family (whose norms take the batch's statistics at eval
    too) runs each half of the batch apart."""
    if prog.loop == "train":
        step = prog.step

        def halved(state, batch, gen=None):
            n = batch["rgb"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()}, gen)
        prog.step = halved
        return

    def wrap(step):
        def halved(batch):
            n = batch["rgb"].shape[0] // 2
            outs = [step({k: v[sl] for k, v in batch.items()})
                    for sl in (slice(0, n), slice(n, None))]
            return dict(outs[0], out3=torch.cat([o["out3"] for o in outs]),
                        out4=torch.cat([o["out4"] for o in outs]))
        return halved
    prog.ev._steps = [wrap(s) for s in prog.ev._steps]


def one_row(prog) -> None:
    """Every cascade stage hands the batch's first pair the answer of the
    second: one wrong slot in each batch, the rest sound."""
    def wrap(step):
        def mixed(batch):
            out = step(batch)
            rows = torch.arange(out["out3"].shape[0], device=out["out3"].device)
            rows[0] = 1
            return dict(out, out3=out["out3"][rows], out4=out["out4"][rows])
        return mixed
    prog.ev._steps = [wrap(s) for s in prog.ev._steps]


def _scaled_lr(prog, factor) -> None:
    """Each optimizer update runs at ``factor(t)`` times its rate (t = 1, 2,
    ...), the schedule left as it is."""
    opt = prog.state.optimizer
    step, count = opt.step, [0]

    def scaled(*a, **k):
        count[0] += 1
        f = factor(count[0])
        for g in opt.param_groups:
            g["lr"] *= f
        try:
            return step(*a, **k)
        finally:
            for g in opt.param_groups:
                g["lr"] /= f
    opt.step = scaled


def adam_lr_double(prog) -> None:
    """Adam steps at twice the scheduled rate."""
    _scaled_lr(prog, lambda t: 2.0)


def adam_no_bias_correction(prog) -> None:
    """Adam without its bias correction: the update m / sqrt(v) in place of
    m_hat / sqrt(v_hat), a rate (1 - 0.9^t) / sqrt(1 - 0.999^t) times the
    scheduled one (3.2x at the first update)."""
    _scaled_lr(prog, lambda t: (1 - 0.9 ** t) / (1 - 0.999 ** t) ** 0.5)


def unchanged_state(prog) -> None:
    """The optimizer never updates: the step returns its state unchanged."""
    prog.state.optimizer.step = lambda *a, **k: None


FAULTS = {"swap_answers": swap_answers, "one_row": one_row, "half_batch": half_batch,
          "unchanged_state": unchanged_state, "adam_lr_double": adam_lr_double,
          "adam_no_bias_correction": adam_no_bias_correction}


def applicable(loop: str, family: str):
    """The faults a cell can have, as its loop (``loops/<loop>.py``) names
    them for its reference family."""
    from h100_bench.harness import loop_module
    from h100_bench.reference import nets

    return loop_module(loop).faults(nets.family(family))
