"""The ways a cell drives the program, one file each (the traffic's
``loop``), found by ``harness.loop_module``. A loop defines:

* ``faults(family)``: the names of ``faults.py`` that a cell of this loop
  and reference family (``reference/families/<family>.py``) can have;
* ``prepare(ctx)``: set-up before the program is built (``ctx.phase``
  marks a set-up phase);
* ``build(ctx)``: the program's objects for the loop, on ``ctx.prog``
  (whose ``models`` are built and loaded);
* ``warm(ctx)``: the warm-up (after any planted fault), with whatever the
  check reads of it; returns the index of the next unit;
* ``run(ctx, start, seconds=None, count=None, record=False)``: units from
  ``start`` until ``count`` or ``seconds``; ``record`` keeps what the check
  compares; returns dict(units, seconds, next, ...);
* ``end_to_end(ctx, win)``: the window's end-to-end metrics but setup_s;
* ``release(ctx)``: keep on ``ctx`` what the check needs, drop the rest;
* ``check(ctx, control, count_flops)``: (numbers, the control's numbers or
  None, the reference's FLOPs of one unit or None), computed once the
  program is freed, TF32 off;
* ``failed(ctx, numbers)``: the answers counted as failed in a run that is
  not correct.
"""
