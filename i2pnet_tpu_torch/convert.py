"""The weight bridges: JAX/flax variables, and the reference's PyTorch
``RegNet_v2`` checkpoints, -> the port's ``state_dict``.

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

The reference's released weights come the other way round: its
``state_dict`` is first mapped onto the flax tree by the rules of
``tools/convert_torch_checkpoint.py`` (``reference_to_flax_free``,
``reference_to_flax_proj``, copies of its ``convert_free_point`` and
``convert_proj``), then through ``flax_to_state_dict``
(``reference_to_state_dict``):

  Conv2d 3x3 (out, in, kh, kw)      -> Conv kernel (kh, kw, in, out)
  Conv2d 1x1 / Conv1d k=1           -> Dense kernel (in, out)
  BatchNorm weight / bias           -> BatchNorm scale / bias
  BatchNorm running_mean / var      -> batch_stats mean / var
  the proj family's stateless BN    -> BatchStatsNorm scale / bias
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Tuple

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


def _conv3x3(w):  # (out, in, kh, kw) -> (kh, kw, in, out)
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _dense(w):  # (out, in, 1[, 1]) or (out, in) -> (in, out)
    w = np.asarray(w)
    return w.reshape(w.shape[0], w.shape[1]).T


def _set(tree: dict, path: Tuple[str, ...], value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.asarray(value)


def _rgb_encoder(sd, params, bn) -> None:
    """RGB_net{1..3}: conv at sequential index 4 i, its BatchNorm at 4 i + 1."""
    for stage in range(3):
        src = f"RGB_net{stage + 1}"
        dst = ("rgb_encoder", f"RGBEncoderStage_{stage}")
        i = 0
        while f"{src}.{i * 4}.weight" in sd:
            _set(params, dst + (f"Conv_{i}", "kernel"), _conv3x3(sd[f"{src}.{i * 4}.weight"]))
            _set(params, dst + (f"Conv_{i}", "bias"), sd[f"{src}.{i * 4}.bias"])
            bn(dst + (f"BatchNorm_{i}",), f"{src}.{i * 4 + 1}")
            i += 1


def _pointwise(sd, params, bn, bn_scope: str):
    """The pointwise-conv stacks (Conv2d 1x1 with an optional BatchNorm,
    ``bn_linear``) as (stack, single) setters."""

    def single(src_prefix, dst_scope):
        _set(params, dst_scope + ("Dense_0", "kernel"), _dense(sd[f"{src_prefix}.conv.weight"]))
        _set(params, dst_scope + ("Dense_0", "bias"), sd[f"{src_prefix}.conv.bias"])
        if f"{src_prefix}.bn_linear.weight" in sd:
            bn(dst_scope + (bn_scope,), f"{src_prefix}.bn_linear")

    def stack(src_prefix, dst_scope):
        i = 0
        while f"{src_prefix}.{i}.conv.weight" in sd:
            single(f"{src_prefix}.{i}", dst_scope + (f"PointwiseConv_{i}",))
            i += 1

    return stack, single


def _heads_and_tail(sd, params, stack, single) -> None:
    """The cost volumes, flow predictors, set-upconvs, pose heads (Conv1d
    k=1 at sequential index 0) and the learned loss weights."""
    for cv in ("cost_volume1", "cost_volume2"):
        stack(f"{cv}.mlp1_convs", (cv, "mlp1_convs"))
        stack(f"{cv}.mlp2_convs", (cv, "mlp2_convs"))
        stack(f"{cv}.mlp2_convs_2", (cv, "mlp2_convs_2"))
        single(f"{cv}.pi_encoding", (cv, "pi_encoding"))
        single(f"{cv}.pc_encoding", (cv, "pc_encoding"))
    for fp in ("flow_predictor0", "flow_predictor0_predict", "flow_predictor0_w"):
        stack(f"{fp}.mlp_conv", (fp, "mlp_conv"))
    for up in ("set_upconv0_w_upsample", "set_upconv0_upsample"):
        stack(f"{up}.mlp_conv", (up, "mlp_conv"))
        stack(f"{up}.mlp2_conv", (up, "mlp2_conv"))
    for head in ("l4_head", "l3_head"):
        for sub in ("hidden_layer", "quat_head", "trans_head"):
            key = f"{head}.{sub}.composed_module.0"
            _set(params, (head, sub, "kernel"), _dense(sd[key + ".weight"]))
            _set(params, (head, sub, "bias"), sd[key + ".bias"])
    _set(params, ("sq",), sd["sq"])
    _set(params, ("sx",), sd["sx"])


def reference_to_flax_free(sd: Dict[str, np.ndarray]) -> dict:
    """The reference's free-point ``RegNet_v2`` state_dict (numpy arrays,
    no ``module.`` prefix) -> ``{'params', 'batch_stats'}``, as
    ``tools/convert_torch_checkpoint.py`` ``convert_free_point`` maps it.
    A key the mapping reads and the file lacks raises ``KeyError``."""
    params: dict = {}
    stats: dict = {}

    def bn(dst_scope, prefix):
        _set(params, dst_scope + ("scale",), sd[prefix + ".weight"])
        _set(params, dst_scope + ("bias",), sd[prefix + ".bias"])
        _set(stats, dst_scope + ("mean",), sd[prefix + ".running_mean"])
        _set(stats, dst_scope + ("var",), sd[prefix + ".running_var"])

    _rgb_encoder(sd, params, bn)
    # the set-abstraction levels: mlp_convs.i (Conv2d 1x1) and mlp_bns.i
    sa_map = {f"LiDAR_lv{k}": f"lidar_lv{k}" for k in range(1, 5)}
    sa_map["layer_idx"] = "layer_idx"
    for src, dst in sa_map.items():
        i = 0
        while f"{src}.mlp_convs.{i}.weight" in sd:
            _set(params, (dst, f"Dense_{i}", "kernel"), _dense(sd[f"{src}.mlp_convs.{i}.weight"]))
            _set(params, (dst, f"Dense_{i}", "bias"), sd[f"{src}.mlp_convs.{i}.bias"])
            bn((dst, f"BatchNorm_{i}"), f"{src}.mlp_bns.{i}")
            i += 1
    stack, single = _pointwise(sd, params, bn, "BatchNorm_0")
    _heads_and_tail(sd, params, stack, single)
    return {"params": params, "batch_stats": stats}


def reference_to_flax_proj(sd: Dict[str, np.ndarray]) -> dict:
    """The reference's projection ``RegNet_v2`` (modellearn_proj_center)
    state_dict -> ``{'params', 'batch_stats'}``, as
    ``tools/convert_torch_checkpoint.py`` ``convert_proj`` maps it: its
    point-side BatchNorms keep no running statistics and become
    ``BatchStatsNorm_0`` scale / bias; only the RGB encoder has
    batch_stats."""
    params: dict = {}
    stats: dict = {}

    def bn_running(dst_scope, prefix):
        _set(params, dst_scope + ("scale",), sd[prefix + ".weight"])
        _set(params, dst_scope + ("bias",), sd[prefix + ".bias"])
        _set(stats, dst_scope + ("mean",), sd[prefix + ".running_mean"])
        _set(stats, dst_scope + ("var",), sd[prefix + ".running_var"])

    def bn_stateless(dst_scope, prefix):
        _set(params, dst_scope + ("scale",), sd[prefix + ".weight"])
        _set(params, dst_scope + ("bias",), sd[prefix + ".bias"])

    _rgb_encoder(sd, params, bn_running)
    stack, single = _pointwise(sd, params, bn_stateless, "BatchStatsNorm_0")
    for k in range(1, 5):
        stack(f"LiDAR_lv{k}.mlp_convs", (f"lidar_lv{k}", "mlp_convs"))
    stack("layer_idx.mlp_convs", ("layer_idx", "mlp_convs"))
    _heads_and_tail(sd, params, stack, single)
    return {"params": params, "batch_stats": stats}


def reference_to_state_dict(raw: Mapping, proj: bool) -> dict:
    """A reference checkpoint as ``torch.load`` gives it -> the port's
    ``state_dict``: its ``model_state_dict`` where it has one, a leading
    DataParallel ``module.`` stripped from each key (only a leading one:
    interior names such as ``composed_module.0`` stay), then
    ``reference_to_flax_proj`` or ``reference_to_flax_free`` and
    ``flax_to_state_dict``."""
    sd = raw.get("model_state_dict", raw)

    def strip(k):
        return k[len("module."):] if k.startswith("module.") else k

    sd = {strip(k): (v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor)
                     else np.asarray(v)) for k, v in sd.items()}
    return flax_to_state_dict(reference_to_flax_proj(sd) if proj else reference_to_flax_free(sd))
