"""The weight bridge: JAX/flax variables -> the port's ``state_dict``.

The port names its submodules after the flax scopes, so the bridge is a
rename of each leaf plus two layout rules (the reverse of
``tools/convert_torch_checkpoint.py``):

  Dense kernel (in, out)            -> ``weight`` (out, in)
  Conv kernel (kh, kw, in, out)     -> ``weight`` (out, in, kh, kw)
  BatchNorm scale / bias            -> ``weight`` / ``bias``
  batch_stats mean / var            -> ``running_mean`` / ``running_var``
  top-level sq / sx                 -> ``sq`` / ``sx``, as they are

Arrays come in as numpy (``np.asarray`` of each leaf); nothing here
imports jax. ``load_optax_adam_state`` carries a JAX train state's Adam
moments across with the same renaming, so training resumes in the port.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}
_AS_IS = ("sq", "sx")


def flax_to_state_dict(variables: Mapping) -> dict:
    """``{'params': ..., 'batch_stats': ...}`` nested dicts of arrays ->
    ``{dotted name: f32 tensor}``. Every leaf maps to exactly one entry;
    an unknown leaf name or a collision raises ``ValueError``."""
    out: dict = {}

    def walk(tree: Mapping, path: tuple) -> None:
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,))
                continue
            a = np.array(value, dtype=np.float32)  # a writable copy
            if not path and key in _AS_IS:
                name = key
            elif key in _LEAF_NAMES:
                name = ".".join(path + (_LEAF_NAMES[key],))
                if key == "kernel":
                    a = a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"unknown flax leaf {'/'.join(path + (key,))}")
            if name in out:
                raise ValueError(f"two flax leaves map to {name}")
            out[name] = torch.from_numpy(np.ascontiguousarray(a))

    for collection in ("params", "batch_stats"):
        walk(variables.get(collection, {}), ())
    return out


def load_flax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Load converted flax variables into ``model`` with ``strict=True``."""
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model


def _find_adam_state(tree):
    """(count, mu, nu) of optax's ``ScaleByAdamState`` inside a chain's
    state: the NamedTuple of a live state, or the dict that a checkpoint
    restored without a target tree holds in its place (orbax gives the
    chain's tuples back as lists)."""
    if isinstance(tree, Mapping):
        if {"count", "mu", "nu"} <= set(tree):
            return tree["count"], tree["mu"], tree["nu"]
        return None
    if all(hasattr(tree, k) for k in ("count", "mu", "nu")):
        return tree.count, tree.mu, tree.nu
    if isinstance(tree, (tuple, list)):
        for sub in tree:
            found = _find_adam_state(sub)
            if found is not None:
                return found
    return None


def load_optax_adam_state(state, opt_state) -> None:
    """Load the Adam state of an optax chain built by the JAX package's
    ``make_optimizer`` (live, or as a checkpoint restored without a target
    tree gives it) into a port ``TrainState`` (``train/state.py``):
    ``mu``/``nu`` -> ``exp_avg``/``exp_avg_sq`` of each parameter, by the
    renaming of ``flax_to_state_dict``; ``count`` -> each parameter's
    ``step`` and the state's update count, which sets the schedule's rate.
    Load the parameters themselves with ``load_flax_variables`` first."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no optax ScaleByAdamState (count, mu, nu) in opt_state")
    count = int(np.asarray(adam[0]))
    mu = flax_to_state_dict({"params": adam[1]})
    nu = flax_to_state_dict({"params": adam[2]})
    params = dict(state.model.named_parameters())
    if set(mu) != set(params) or set(nu) != set(params):
        raise ValueError("the optax moments do not match the model's parameters")
    for name, p in params.items():
        state.optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": mu[name].to(p.device),
            "exp_avg_sq": nu[name].to(p.device),
        }
    state.set_step(count)
