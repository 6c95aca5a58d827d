"""CUDA graphs of fixed segments of a module's eval forward.

A segment is a function of tensors made of plain PyTorch operators only:
no hand-written kernel launcher (``ops/*_cuda.py``) runs inside one, so
every kernel call and every module boundary around it still runs eagerly
and shows as such in a profiler's trace. ``Graphs.run(owner, name, fn,
*inputs)`` replays ``fn`` as a CUDA graph where that is safe and otherwise
calls it:

* it replays only where ``eager_reason`` finds nothing against it: CUDA
  tensors, the owner in eval mode, grad off (``inference_mode`` or
  ``no_grad``), no ambient mesh (``BatchStatsNorm`` all-reduces under
  one), no ``torch.export`` or ``torch.compile`` tracing, and no CUDA graph
  capture already running on the stream (a capture of the whole forward
  records every kernel of the segment as it would eagerly);
* the key is the inputs' shapes, strides, dtypes and device, inference
  mode, and the call-time switches read inside the segments:
  ``I2PNET_PW_BN_F32`` (``nn/layers.py``) and the float32 matmul
  precision. A graph never replays a route the process no longer takes;
* the first call with a key runs eagerly, as the warm-up; the second
  captures a graph and replays it; later calls copy their inputs into the
  graph's static buffers and replay;
* the outputs are fresh copies, never the graph's buffers, so an output
  the caller keeps is not overwritten by the next replay;
* at most ``CAP`` graphs per segment; past it the segment runs eagerly;
* a graph reads the owner's parameters and buffers where they lay when it
  was captured. Values written in place (an optimizer step,
  ``load_state_dict``) reach the next replay; if any of them moved
  (``.to``, ``load_state_dict(..., assign=True)``), every graph is dropped
  and the warm-up starts again. ``clear()`` drops them by hand (after
  replacing a submodule).

Each capture opens the span ``i2pnet/model/graph_capture`` and each replay
``i2pnet/model/graph_replay`` (``utils/trace.py``); the spans inside a
segment open on its eager calls only. ``counts[segment]`` tallies
``capture``, ``replay`` (a capturing call replays too), ``dropped`` and
``eager:<reason>``: a reason of ``eager_reason``, ``warmup`` or ``cap``.
"""

from __future__ import annotations

import collections
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from i2pnet_tpu_torch.parallel.mesh import ambient_mesh
from i2pnet_tpu_torch.utils.trace import span

CAP = 4  # graphs per segment of one owner


def eager_reason(owner: torch.nn.Module, device: torch.device) -> Optional[str]:
    """Why a segment of ``owner`` on ``device`` must run eagerly, or None
    where it may replay."""
    if device.type != "cuda":
        return "cpu"
    if owner.training:
        return "training"
    if torch.is_grad_enabled():
        return "grad"
    if ambient_mesh() is not None:
        return "mesh"
    if torch.compiler.is_exporting() or torch.compiler.is_compiling():
        return "export"
    if torch.cuda.is_current_stream_capturing():
        return "capturing"
    return None


def graph_key(inputs: Sequence[torch.Tensor]) -> tuple:
    """What a graph is captured for: the inputs' layouts and the call-time
    switches read inside the segments."""
    return (tuple((tuple(x.shape), x.stride(), x.dtype, x.device) for x in inputs),
            torch.is_inference_mode_enabled(),
            os.environ.get("I2PNET_PW_BN_F32") == "1",
            torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)


class _Graph:
    """One segment captured as a CUDA graph (on a side stream,
    ``torch.cuda.graph``) on static copies of its first inputs; ``replay``
    recomputes its static outputs from whatever the static inputs hold."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor]):
        self.device = inputs[0].device
        self.inputs = tuple(torch.empty_like(x).copy_(x) for x in inputs)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), \
                torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.outputs = tuple(fn(*self.inputs))

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()


class Graphs:
    """The segment graphs of one owner module, held by it. A copy of the
    owner (``copy.deepcopy``, pickling) starts with none."""

    def __init__(self):
        self.counts: Dict[str, collections.Counter] = collections.defaultdict(collections.Counter)
        self.clear()

    def clear(self) -> None:
        """Drop every graph; the next calls warm up anew."""
        self._graphs: Dict[str, Dict[tuple, _Graph]] = collections.defaultdict(dict)
        self._seen: Dict[str, set] = collections.defaultdict(set)
        self._slots: List[tuple] = []
        self._where: tuple = ()

    def __reduce__(self):
        return (Graphs, ())

    def _places(self) -> tuple:
        return tuple(0 if d[k] is None else d[k].data_ptr() for d, k in self._slots)

    def _weights_moved(self) -> bool:
        """Whether a parameter or buffer of the owner lies elsewhere than
        when the graphs were captured; if so, they are dropped."""
        if not self._slots or self._places() == self._where:
            return False
        self.clear()
        return True

    def _note_weights(self, owner: torch.nn.Module) -> None:
        if not self._slots:
            self._slots = [(d, k) for m in owner.modules()
                           for d in (m._parameters, m._buffers) for k in d]
            self._where = self._places()

    def run(self, owner: torch.nn.Module, name: str, fn: Callable,
            *inputs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """``fn(*inputs)`` (a tuple of tensors), replayed from the graph of
        segment ``name`` of ``owner`` where that is safe."""
        counts = self.counts[name]
        reason = eager_reason(owner, inputs[0].device)
        if reason is None:
            if self._weights_moved():
                counts["dropped"] += 1
            key = graph_key(inputs)
            graphs, seen = self._graphs[name], self._seen[name]
            g = graphs.get(key)
            if g is None:
                if key not in seen:
                    reason = "warmup"
                    seen.add(key)
                elif len(graphs) >= CAP:
                    reason = "cap"
                else:
                    with span("i2pnet/model/graph_capture"):
                        self._note_weights(owner)
                        g = graphs[key] = _Graph(fn, inputs)
                    counts["capture"] += 1
        if reason is not None:
            counts["eager:" + reason] += 1
            return tuple(fn(*inputs))
        with span("i2pnet/model/graph_replay"):
            for s, x in zip(g.inputs, inputs):
                s.copy_(x)
            g.replay()
            out = tuple(o.clone() for o in g.outputs)
        counts["replay"] += 1
        return out
