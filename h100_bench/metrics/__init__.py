"""One reader per per-layer metric, in the file named after the metric.
A reader defines ``read(r)``, taking the traced run's reading (``loop``,
``units``, ``pairs_per_unit``, ``units_per_s``, ``flops_per_unit``,
``peak_flops``, ``range_s``, ``kernel_calls``, ``busy_s``, ``window_s``,
as ``harness.run_cell`` fills it) and returning the metric's value or
None where the run has nothing for it to read, and may define
``RANGES``: {label: {"modules": [attribute names of each model's
submodules], "backward": bool}}, the ranges the harness then opens around
those modules (``bench/<label>``) in the traced slice."""
