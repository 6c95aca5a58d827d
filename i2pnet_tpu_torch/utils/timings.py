"""Per-stage online mean and variance of wall times (port of
``i2pnet_tpu/utils/timings.py``).

Each checkpoint fences the device with ``torch.cuda.synchronize(device)``,
where the JAX version waits with ``jax.effects_barrier`` or a
``device_get``, so a stage's time holds the device work queued in it. The
device is explicit: a CUDA device without a card raises, and nothing falls
back to the host's clock alone. On the CPU, work is done when its call
returns and no fence is needed. Every fence stalls the launch queue, so
enable only while profiling.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch


class Timings:
    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Timings on {self.device}: no CUDA device")
        self.stats: Dict[str, list] = {}  # name -> [count, mean, M2]
        self._last: Optional[float] = None

    def reset(self) -> None:
        """Start a measurement chain (keeps the accumulated statistics)."""
        self._sync()
        self._last = time.perf_counter()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def time(self, name: str, value=None) -> None:
        """Record the time since the previous checkpoint under ``name``.
        ``value`` (what the stage produced) is accepted as in the JAX
        version; the fence waits for all of the device's work either way."""
        self._sync()
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return
        dt = now - self._last
        self._last = now
        cnt, mean, m2 = self.stats.setdefault(name, [0, 0.0, 0.0])
        cnt += 1
        delta = dt - mean
        mean += delta / cnt
        m2 += delta * (dt - mean)
        self.stats[name] = [cnt, mean, m2]

    def summary(self) -> Dict[str, dict]:
        out = {}
        for name, (cnt, mean, m2) in self.stats.items():
            var = m2 / cnt if cnt > 0 else 0.0
            out[name] = {"count": cnt, "mean_s": mean, "std_s": var**0.5}
        return out

    def __str__(self) -> str:
        return "\n".join(
            f"{k}: {v['mean_s']*1e3:.2f} +- {v['std_s']*1e3:.2f} ms (n={v['count']})"
            for k, v in self.summary().items()
        )
