"""The port's spans: named intervals of the program in a profiler's trace.

``span(name)`` is a ``torch.profiler.record_function`` while a profiler
records, so the span lands in the same trace as the operators and the
kernels they launch, on the profiler's one clock. With no profiler it is
one shared no-op context, and costs one check of the profiler's flag: no
host clock, no buffer, no setting. Record the spans by running the program
inside any ``torch.profiler.profile`` context (``evaluate_torch.py``,
``train_torch.py`` or one's own loop).

Every span is named ``i2pnet/<layer>/<unit>`` and is coarse: a batch's copy
to the card, the cascade and its stages, the model's encoders and cost
volumes, the train step and its forward, backward and optimizer. The
kernel launchers open none: each kernel shows in the trace under its own
name.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: ``name``'s profiler range while a profiler
    records, else a shared no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
